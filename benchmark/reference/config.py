"""Configuration tree for the quadruped stack (PyTorch port).

An own copy of ``paddlerobotics_tpu/core/config.py``: the same frozen
dataclasses, field for field, so a config built for one package reads the
same in the other. The port imports nothing of the JAX package, so it
keeps this copy rather than sharing it.

Two fields are kept for parity and ignored by the port:
``SimConfig.use_pallas`` and ``SimConfig.pallas_block``. In the port the
device picks the implementation of the physics control step: tensors on a
CUDA device go through the hand-written kernel
(``paddlerobotics_torch/ops/physics_step.py``), tensors on the CPU through
its plain PyTorch version (``paddlerobotics_torch/sim/sbatch.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Which observation channels are assembled, mirroring SENSOR_MODE.

    Reference: ETGRL/train.py:262-277 and deployment/test.py:26-46 for the
    resulting dims. The flat layout follows the reference's alphabetical
    sensor-name sort (deployment/envs/EnvWrapper.py:98):
      BaseDisplacement(3) < FootContactSensor(4) < IMU(6) < MotorAngleAcc(24)
    with the ETG signal (12) appended last (EnvWrapper.py:103-107).
    """

    dis: bool = True          # base displacement/velocity (3)
    motor: int = 1            # 1 → angles+velocities (24); 2 → angles (12); 0 → off
    imu: int = 1              # 1 → rpy+drpy (6); 2 → drpy (3); 0 → off
    contact: bool = True      # foot contacts (4)
    etg: bool = True          # ETG joint-space signal (12)
    etg_obs: bool = False     # ETG phase-feature observation (20)
    footpose: bool = False    # foot positions in base frame (12)
    dynamic_vec: bool = False # randomized dynamics vector echo
    force_vec: bool = False   # external force vector echo (3)
    noise: bool = False       # additive sensor noise on obs
    normal: bool = True       # normalize channels (EnvWrapper.py:66-92)
    # Temporal history ("RNN" sub-dict in the reference).
    rnn_time_steps: int = 0
    rnn_time_interval: int = 1
    rnn_mode: str = "None"    # None | stack | GRU

    @property
    def base_obs_dim(self) -> int:
        d = 0
        if self.dis:
            d += 3
        if self.contact:
            d += 4
        if self.imu == 1:
            d += 6
        elif self.imu == 2:
            d += 3
        if self.motor == 1:
            d += 24
        elif self.motor == 2:
            d += 12
        if self.etg:
            d += 12
        if self.etg_obs:
            d += 20
        if self.footpose:
            d += 12
        if self.dynamic_vec:
            d += 48
        if self.force_vec:
            d += 3
        return d

    @property
    def obs_dim(self) -> int:
        d = self.base_obs_dim
        if self.rnn_time_steps > 0 and self.rnn_mode == "stack":
            d *= self.rnn_time_steps + 1
        return d


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Reward-term weights, mirroring Param_Dict (ETGRL/train.py:255-261).

    Channels: torso (forward progress), up (orientation upright), feet
    (swing-foot clearance/placement), tau (torque penalty), badfoot
    (illegal contact penalty), footcontact (stance-contact consistency),
    stand (stand-still shaping), plus the velx success channel
    (train.py:156: success when velx >= 0.3 m/s).
    """

    torso: float = 1.5
    up: float = 0.6
    feet: float = 0.3
    tau: float = 0.07
    stand: float = 0.0
    badfoot: float = 0.1
    footcontact: float = 0.1
    # Centering/heading shaping: penalize lateral displacement from the
    # course centerline (world |y|), lateral speed, and yaw error. NOT a
    # reference Param_Dict channel — a calibration extension for the
    # balance-beam task (the reference handles the beam with the
    # narrow-stance step_y workflow, README.md:65, and ships a trained
    # model rather than a recipe). Default 0 keeps every other task on
    # the exact reference weight vector; TASK_PRESETS['balance_beam']
    # turns it on.
    lateral: float = 0.0
    # Global scale applied to the summed shaped reward (train.py --reward_p).
    reward_p: float = 5.0
    # Desired forward velocity (train.py --vel_d).
    vel_d: float = 0.5
    # Episode terminates when torso drops below this height or rolls over.
    done_height: float = 0.15
    done_rpy: float = 0.8


@dataclasses.dataclass(frozen=True)
class RandomConfig:
    """Domain-randomization toggles, mirroring Random_Param_Dict
    (ETGRL/train.py:253-254) and the param2dynamic_dict ranges
    (train.py:112-126)."""

    random_dynamics: bool = False
    random_force: bool = False
    # Scale on the normalized [-1,1] dynamics sample before param2dynamic
    # (1.0 = the reference's full ranges; smaller = curriculum-mild DR).
    dynamics_scale: float = 1.0
    # DR curriculum: anneal the scale from dr_scale_start to
    # dynamics_scale over dr_curriculum_steps env steps (0 = no
    # curriculum, constant dynamics_scale). The scale is a traced value
    # in BEnvState — annealing never recompiles.
    dr_scale_start: float = 0.2
    dr_curriculum_steps: int = 0
    # Adaptive (success-gated) curriculum, an alternative to the linear
    # schedule above: widen the DR scale while training succeeds, back
    # off when it struggles (ADR-style; avoids the mid-anneal collapse
    # documented in docs/dr_study.md). Takes precedence over
    # dr_curriculum_steps when enabled.
    dr_adaptive: bool = False
    # Per-draw scale jitter: each episode's draw uses scale*U(0,1)
    # instead of the full scale, so part of the batch always trains
    # near nominal dynamics (ADR boundary-sampling). Load-bearing on
    # terrain where any perturbation stalls the gait (stairs —
    # docs/dr_study.md round-3 addendum).
    dr_scale_jitter: bool = False
    dr_success_lo: float = 0.30   # EMA success below → shrink scale
    dr_success_hi: float = 0.50   # EMA success above → grow scale
    dr_step_up: float = 0.02      # scale increment per rollout chunk
    dr_step_down: float = 0.01
    # Ranges (low, high) for randomized physical params; the param2dynamic
    # mapping in envs/randomize.py converts [-1,1]^48 into these.
    latency_range: Tuple[float, float] = (0.0, 0.08)   # seconds
    friction_range: Tuple[float, float] = (0.0, 20.0)
    basemass_range: Tuple[float, float] = (0.5, 3.0)   # scale of extra mass, kg
    kp_range: Tuple[float, float] = (20.0, 200.0)
    kd_range: Tuple[float, float] = (0.0, 5.0)
    max_force: float = 20.0                            # random push magnitude, N


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics/integration constants.

    The reference steps PyBullet at ``time_step`` with ``action_repeat``
    inner steps per control step (minitaur.py:92-93; control dt 0.026 s
    at train.py:297). We keep control dt = 0.026 and split it into
    ``action_repeat`` semi-implicit Euler substeps.
    """

    control_dt: float = 0.026
    action_repeat: int = 10
    # Soft-contact model constants (replaces PyBullet's LCP solver).
    contact_stiffness: float = 4000.0
    contact_damping: float = 60.0
    friction_coef: float = 0.6
    # Friction regularization velocity scale (m/s): the Coulomb force
    # ramps in over ~this much slip. 0.25 (round 1) lets a narrow-stance
    # robot skate sideways where PyBullet's stiction would hold; 0.08
    # restores enough lateral stiction for the reference's (golden-trace)
    # stance to climb stairs. At 0.08 the near-zero-slip viscous slope
    # μ·fn/vs (≈225 N/(m/s) per standing foot) exceeds the explicit
    # substep's stability limit 2m/dt — the tangential force is therefore
    # impulse-capped per point (see friction_point_mass) so stiction
    # cannot ring.
    friction_vel_scale: float = 0.08
    # Per-contact-point effective masses (kg) for the tangential impulse
    # cap |F_t| ≤ m_eff·|v_t|/dt (friction may at most arrest the point
    # within one substep — the explicit-integrator analogue of an LCP
    # stiction constraint): foot≈calf+foot, knee≈calf, base≈trunk.
    # (0.25 is marginal — the calf mode still rings at 1.8 rad/s; ≤0.15
    # settles a standing robot to qd = 0 exactly. 0.1 ≈ the foot+calf
    # mass reflected at the foot.)
    friction_cap_mass_foot: float = 0.1
    friction_cap_mass_knee: float = 0.15
    friction_cap_mass_base: float = 4.0
    # PD motor defaults (a1.py:75-80: kp 100, kd [1,2,2]).
    motor_kp: float = 100.0
    motor_kd: Tuple[float, float, float] = (1.0, 2.0, 2.0)
    torque_limit: float = 33.5         # A1 motor torque limit (N·m)
    # Action interpolation across the repeat window (minitaur.py:1384-1401).
    enable_action_interpolation: bool = True
    # Observed-state latency (minitaur.py:1172-1193); in control steps the
    # buffer holds `latency_buffer_len` past substep snapshots.
    control_latency: float = 0.002
    latency_buffer_len: int = 32   # covers the 0–80 ms randomization range
    # How many newest ring slots the policy-obs latency blend may reach.
    # 0 = auto: the full ring when `random.random_dynamics` randomizes
    # control_latency (0-80 ms, train.py:116), else 2 (the 2 ms nominal
    # needs one blend pair — 16× less HBM read per observation build).
    # Drivers that INJECT dynamics with larger latencies into
    # `env.reset(dyn=...)` while random_dynamics is off (dynamics ID,
    # feasibility probes) must set this to latency_buffer_len.
    obs_latency_taps: int = 0
    # Sensor latency applied to the PD loop's (q, q̇) input — the
    # reference's `pd_latency` (minitaur.py:100, default 0.0). A1 never
    # overrides it (a1.py:225-273 passes no pd_latency), so the reference
    # PD acts on the CURRENT pre-substep state; `control_latency` delays
    # only the POLICY observation (_GetControlObservation vs
    # _GetPDObservation, minitaur.py:1195-1205). Static (not randomized —
    # train.py:112-126 randomizes control_latency only).
    pd_latency: float = 0.0
    # Motor-command clipping (a1.py:62: ±0.2 rad change per step).
    enable_clip_motor_commands: bool = False
    max_motor_angle_change: float = 0.2
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.8)
    # Velocity clamps for numerical robustness under large penalty forces.
    max_joint_velocity: float = 100.0
    max_base_velocity: float = 50.0
    # On-rack debug mode (minitaur.py:106, 418): weld the trunk in place,
    # let the legs articulate freely.
    on_rack: bool = False
    # Motor overheat protection (minitaur.ApplyAction:894-901 +
    # constants:43-44): a motor whose |τ| exceeds the shutdown torque for
    # longer than the shutdown time is latched off (τ=0 thereafter).
    # Checked once per CONTROL step here (documented approximation; the
    # reference checks every inner sim step). The 2.45 N·m default is the
    # reference's minitaur value — set ~0.9×TORQUE_LIMIT for A1-scale use.
    motor_overheat_protection: bool = False
    overheat_shutdown_torque: float = 2.45
    overheat_shutdown_time: float = 1.0
    # Pallas megakernel for the control step (TPU only): all substeps of
    # a 1024-env block run in VMEM — ~2.4x the fused-XLA SoA path.
    use_pallas: bool = False
    pallas_block: int = 1024

    @property
    def substep_dt(self) -> float:
        return self.control_dt / self.action_repeat


@dataclasses.dataclass(frozen=True)
class ETGConfig:
    """ETG oscillator constants (ETGRL/train.py:296-301)."""

    T: float = 0.5           # gait period (s)
    T2: float = 0.5          # second-phase period
    dt: float = 0.026
    H: int = 20              # number of RBF basis functions
    sigma_sq: float = 0.04   # RBF width (squared)
    amp: float = 0.2         # oscillator amplitude
    phase: Tuple[float, float] = (-1.5707963267948966, 0.0)
    # Prior control-point geometry (train.py:84-88 defaults).
    steplen: float = 0.05
    footheight: float = 0.1
    penetration: float = 0.01
    # Lateral foot offset (train.py --step_y). step_y = 0.05 reproduces
    # the reference's EXACT golden-trace stance (etg/model.py
    # STANCE_OFFSET_Y); our default is 0.09 (+4 cm wider) — a documented
    # deviation: the reference's narrow stance pitches over at the first
    # stair riser under our penalty-contact physics (PyBullet's LCP
    # stiction holds it), while +4 cm climbs stairs under the default
    # reward weights (docs/reward_calibration.md).
    step_y: float = 0.09
    # Leg phase pairing of the 2-phase oscillator: 'trot' pairs
    # diagonal legs (the reference gait, train.py's ETG), 'bound' pairs
    # front/rear legs (the 2-phase member of the gallop family — what
    # task_mode='gallop' trains), 'auto' resolves to bound for the
    # gallop task and trot otherwise (etg/model.resolve_pairing).
    pairing: str = "auto"


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Terrain/task selection — the reference's nine task modes
    (ETGRL/README.md "nine tasks"; grids at train.py:48-50)."""

    task_mode: str = "ground"   # ground|up_slope|down_slope|up_stair|down_stair|
                                # stairstair|slopeslope|obstacle|gallop|
                                # balance_beam
    step_height: float = 0.08   # stairs rise  (train.py STEP_HEIGHT grid)
    step_width: float = 0.3     # stairs run   (train.py STEP_WIDTH grid)
    slope: float = 0.2          # slope gradient (train.py SLOPE grid)
    terrain_start: float = 0.5  # flat run-in before the feature starts (m)
                                # (0.5 m = the validated stairs recipe)
    beam_width: float = 0.30    # balance-beam plank width (m); the
                                # reference's step_y flag exists "for
                                # balance beam task" (README.md:65) —
                                # the narrow stance keeps feet on the
                                # plank
    beam_length: float = 3.0    # plank length before solid ground resumes


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """SAC hyperparameters (ETGRL/train.py:34-47)."""

    gamma: float = 0.99
    tau: float = 0.005
    alpha: float = 0.2
    # auto-tune alpha toward -action_dim target entropy (off = the
    # reference's fixed alpha, sac.py:45)
    auto_alpha: bool = False
    alpha_lr: float = 3e-4
    # Linear entropy anneal: alpha -> alpha_final over
    # alpha_anneal_steps env steps (0 = reference fixed alpha). The
    # round-3 uphill-slope train trace wanders under the high-entropy
    # sample-efficiency schedule (docs/task_matrix.md); annealing the
    # exploration temperature late in training is the measured arm for
    # settling it. Mutually exclusive with auto_alpha.
    alpha_final: float = 0.05
    alpha_anneal_steps: int = 0
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    batch_size: int = 256
    warmup_steps: int = 10_000
    memory_size: int = 1_000_000
    hidden_dim: int = 256
    log_sig_min: float = -20.0
    log_sig_max: float = 2.0
    # Plasticity stabilizers for high update-to-data schedules
    # (docs/update_schedule.md finding 3: B=256/K=64 and K=256 peak near
    # 5M steps then decay). Off by default — reference parity.
    ln_critic: bool = False            # LayerNorm before each critic ReLU
    # bfloat16 critic matmuls (fp32 accumulate/params) in learn() — MXU-
    # native; opt-in until return parity is recorded per task
    # (docs/perf.md round-4 measurements).
    bf16_matmul: bool = False
    critic_reset_steps: int = 0        # full critic+target+opt re-init
                                       # every N env steps (primacy-bias
                                       # reset; 0 = never)
    # Fraction of envs that roll the open-loop ETG gait (zero residual
    # + small noise) instead of uniform-random residuals during the
    # pre-warmup phase. The reference warms up with only 1e4 SINGLE-env
    # random steps (train.py:163), so its replay is on-gait almost
    # immediately; a large batched warmup of pure random residuals
    # instead fills replay with flailing/falls, and on terrain where
    # falls come fast the critic locks onto the standing optimum
    # (docs/reward_calibration.md round-3 note: rng-seed cold-start
    # collapse). Mixing in on-gait rollouts guarantees walking
    # transitions in early replay wherever the (seeded) gait walks.
    warmup_gait_frac: float = 0.5
    warmup_gait_sigma: float = 0.05    # residual noise on the gait envs
    # Fraction of envs that roll the DETERMINISTIC (mean) action during
    # training instead of the sampled one. The reference evaluates (and
    # deploys) the mean action (mujoco_agent.predict; deployment/
    # test.py:95) but only ever trains on sampled rollouts — on tasks
    # where the sampled policy's dither is load-bearing (balance beam:
    # lateral drift of the mean action, docs/task_matrix.md) the
    # deterministic policy is off-distribution for the critic. SAC is
    # off-policy, so rolling a slice of the batch at the mean puts the
    # eval-time state distribution in replay. 0 = reference behavior.
    det_rollout_frac: float = 0.0


@dataclasses.dataclass(frozen=True)
class ESConfig:
    """ES outer-loop hyperparameters (ETGRL/train.py:36-38, 288-295)."""

    solver: str = "simple_ga"   # simple_ga|simple_es|open_es|pepg|cma_es
    popsize: int = 40
    sigma_init: float = 0.02
    sigma_decay: float = 0.99
    sigma_limit: float = 0.005
    elite_ratio: float = 0.1
    weight_decay: float = 0.005
    es_every_steps: int = 50_000
    es_train_steps: int = 10
    es_episode_len: int = 400
    es_rpm: bool = True         # feed ES rollouts into the SAC replay buffer
    # Evaluate ES fitness at NOMINAL dynamics even when the SAC loop
    # trains under domain randomization. Documented deviation from the
    # reference (its ES episodes inherit whatever env randomization is
    # active): measured on stairstair+DR, population fitness under
    # random draws is survival-noise-dominated and walks the gait
    # prior away from walking (success → 0.00 by 5M steps); the gait
    # prior is a nominal open-loop prior — the policy, conditioned on
    # dynamic_vec, owns the randomization (docs/dr_study.md addendum 2).
    es_nominal_dyn: bool = True
    # DR draw scale for ES fitness when es_nominal_dyn is on: 0.0 =
    # exactly nominal (the shipped round-3 recipe). Setting it to the
    # curriculum floor (e.g. dr_scale_start) evaluates the gait prior
    # under mild randomization — the "robustified prior" arm of
    # docs/dr_study.md (round-4 measurement).
    es_dyn_scale: float = 0.0
    num_params: int = 12
    # Envs for ES population rollouts. The reference evaluates each
    # candidate with ONE serial 400-step episode (run_EStrain_episode,
    # train.py:404-408); riding the full training batch gives B/popsize
    # (~102 at B=4096) episodes per candidate — lower-variance fitness
    # but ~91% of training wall-clock. A dedicated smaller batch keeps
    # ≥8 episodes per candidate at ~3× less ES wall. 0 = use the full
    # training batch.
    es_num_envs: int = 320


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Top-level dual-loop schedule (ETGRL/train.py:354-437)."""

    max_steps: int = 10_000_000
    eval_every_steps: int = 10_000
    e_step: int = 400           # episode length, grows +50/eval up to 600
    e_step_max: int = 600
    e_step_growth: int = 50
    act_mode: str = "traj"      # pose|torque|traj
    act_bound: float = 0.3
    eval_episode_len: int = 600
    num_envs: int = 4096
    seed: int = 0
    enable_action_filter: bool = False  # train.py --enable_action_filter
    x_noise: bool = False               # train.py --x_noise reset jitter
    # Spawn-on-course curriculum (generalizes the reference's
    # reset(x_noise=...) start jitter, train.py:131): on AUTORESET, the
    # first spawn_x_frac of envs respawn at x ~ U(0, spawn_x_max) with
    # heading ~ U(±spawn_yaw) and lateral offset ~ U(±spawn_y), placed
    # at terrain-relative height. Round-4 balance-beam diagnosis
    # (scripts_dev/beam_diag.py): under autoreset every episode dies at
    # plank ENTRY (fall x ≈ 0.51 = terrain_start), so replay holds
    # almost no on-plank experience — mid-course spawns put the course
    # itself in the training distribution. Explicit reset() (the eval
    # protocol and ES baselines) never spawns mid-course. 0 = off.
    spawn_x_max: float = 0.0
    spawn_x_frac: float = 0.5
    spawn_yaw: float = 0.0
    spawn_y: float = 0.0
    # Eval-peak artifact selection: track the best deterministic-eval
    # (return, survival) seen at the eval windows and return THAT
    # policy from train() instead of the final step's. The reference
    # checkpoints every eval window and ships its best artifact
    # (train.py:386-390, 'well-trained model'); under late-training
    # decay (docs/dr_study.md; balance beam round-4) this makes the
    # shipped preset self-contained.
    keep_best_eval: bool = False


@dataclasses.dataclass(frozen=True)
class QuadrupedConfig:
    """Everything needed to build the A1 env + ETG + trainers."""

    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    sensors: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    reward: RewardConfig = dataclasses.field(default_factory=RewardConfig)
    random: RandomConfig = dataclasses.field(default_factory=RandomConfig)
    etg: ETGConfig = dataclasses.field(default_factory=ETGConfig)
    task: TaskConfig = dataclasses.field(default_factory=TaskConfig)
    sac: SACConfig = dataclasses.field(default_factory=SACConfig)
    es: ESConfig = dataclasses.field(default_factory=ESConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **kw) -> "QuadrupedConfig":
        return dataclasses.replace(self, **kw)
