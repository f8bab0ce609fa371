"""The benchmark's plain reference: a frozen PyTorch copy of the port.

Each module here is a copy of the port's module of the same purpose, taken
when the benchmark was defined, so that a later change to the port does not
move the reference it is held against:

    config        core/config.py          a1_model     sim/a1_model.py
    device        core/device.py          smallalg     ops/smallalg.py
    math3d        core/math3d.py          dynamics     sim/dynamics.py
    types_        core/types.py           sbatch       sim/sbatch.py
    terrain       sim/terrain.py          randomize    envs/randomize.py
    sensors       envs/sensors.py         reward       envs/reward.py
    action_filter envs/action_filter.py   oscillator   etg/oscillator.py
    etg_fit       etg/fit.py              etg_model    etg/model.py
    env           envs/batched_env.py     networks     algos/networks.py
    sac           algos/sac.py            replay       algos/replay.py
    init          utils/init.py

Changes from the copies' sources: imports point here; the env's physics
control step is the plain version on every device (never the CUDA kernel);
``columns`` stands in for ``parallel/sharding`` with the one-process layout;
the recurrent actor and the mesh paths are left out. The modules
``deploy``, ``trainer`` and ``counts`` are the benchmark's own: the deploy
policy and a training step written after the port's, and the work counts.

Nothing here imports the port or JAX.
"""
