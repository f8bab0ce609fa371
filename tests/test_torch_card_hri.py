"""The HRI stack's entry points on the card, each with its attention (or
matching) launches counted and its outputs held against the plain attention
or the CPU (every test marked ``cuda``, skipped without one; run with
``python -m pytest --noconftest -m cuda tests/test_torch_card_hri.py``).

Serving with YOLOv4 at 416² and the 317-action controller at its default
widths (6 attention launches per decided frame) and the offline scorer;
controller training at the CLI's full width, its eval, resume, the
ablation fleet and the exported bundle; the YOLOv3 sensor, a cfg-built
Darknet sensor's ``.weights`` round trip, the re-ID encoder, the tracker and
``collect_data.track_frames`` (one ``track_match`` launch per frame), the
gRPC handlers; the native C++ runtime's eval, stream and clip servers; the
backbones and the frozen-graph import; the full-width ERNIE encoder,
``collect_act_emb``, the data loader into training, and the salutation
heads.
"""

import copy

import numpy as np
import pytest
import torch

from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                     AttnCtrlConfig)
from paddlerobotics_torch.hri.perception.scene import SceneSensor
from paddlerobotics_torch.hri.serving import (ProactiveGreetingService,
                                              ServiceConfig)
from paddlerobotics_torch.ops import attention, lap
from paddlerobotics_torch.ops.kernel_time import walker_clip
from torch_card import cuda, ernie  # noqa: F401

pytestmark = pytest.mark.cuda

SIZE = 416                              # YOLOv4 input, the serving resolution
FRAMES = 12                             # 9 fill the window, 3 are decided
STEADY_FRAMES = 50                      # decided frames once the window is full
N_WINDOWS = 64
F_, K_ = 10, 20                         # window: frames × tokens per frame
# serving through the kernel vs through the plain attention, 6 blocks deep
SERVE_TOL = 1e-4
# HRI controller training at the CLI's full width (AttnCtrlConfig(
# num_actions=317): D=512, 6 blocks, 8 heads, ffn 2048, 10 × 20 tokens),
# batch 16, lr 1e-4, l2 0.1; depth cut (cli/train_attention's 10 epochs of
# data → HRI_TRAIN_STEPS steps)
HRI_BATCH, HRI_LR, HRI_L2 = 16, 1e-4, 0.1
HRI_TRAIN_STEPS = 200
HRI_LOSS_WINDOW = 20                    # steps averaged for first / last loss
HRI_HELDOUT = 256                       # numpy windows, one eval_step call
HRI_RESUME_STEPS = 10                   # 10 + save/restore + 10 vs 20
# resumed vs uninterrupted weights: equal unless cuBLAS rounds a call
# differently, and then an entry whose decayed gradient is ~0 may take one
# Adam step (±lr) the other way
HRI_RESUME_TOL = 2 * HRI_LR
HRI_FLEET_BATCHES = 2                   # --synthetic 2 --epochs 1
HRI_BUNDLE_FRAMES = 20                  # decided frames through the bundle
REID_TOL = 1e-4                         # the encoder on the card vs the CPU
TRACK_FRAMES = 100
# track_frames through the plain matching (on the host, ~0.1 s per frame):
# the first frames of the clip, whose logs the kernel's run must repeat
TRACK_PLAIN_FRAMES = 30
GRPC_FRAMES = 20                        # VideoRequests, 11 of them decided
GRPC_EVAL_FRAMES = 10                   # one EvalRequest, its last decided
NATIVE_EVAL_FRAMES = 10                 # frames of one native EvalRequest
NATIVE_EVAL_REQUESTS = 5
NATIVE_TOL = 1e-6                       # native eval vs the controller here
NATIVE_STREAM_FRAMES = 30               # frames of each stream arm
CLIP_REQUESTS = 5                       # R(2+1)D clips through C++
CLIP_TOL = 1e-5                         # clip scores vs a direct model call
BACKBONE_RTOL = 1e-4                    # card vs CPU, of the output's scale
ERNIE_ROWS = 317                        # the serving action catalog
ERNIE_TOL = 1e-4                        # kernel vs plain, of each output's scale
HRI_DATA_STEPS = 3                      # trainer steps on loader batches
# a Darknet cfg at 416² with every section type the importer reads: strided
# and grouped convolutions, both max pools, a shortcut, an upsample, routes
# with groups and two sources, two [yolo] heads (13² and 52²) with their
# own scale_x_y; the 512-channel 13² map feeds the tokens
DARKNET_CFG = """
[net]
width=416
height=416
channels=3

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=mish

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[convolutional]
batch_normalize=1
filters=256
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=5
stride=1

[convolutional]
batch_normalize=1
filters=512
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=0
filters=255
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=6,7,8
anchors=12,16, 19,36, 40,28, 36,75, 76,55, 72,146, 142,110, 192,243, 459,401
classes=80
scale_x_y=1.05

[route]
layers=-4

[convolutional]
batch_normalize=1
filters=128
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1,-9

[convolutional]
batch_normalize=0
filters=255
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=12,16, 19,36, 40,28, 36,75, 76,55, 72,146, 142,110, 192,243, 459,401
classes=80
scale_x_y=1.2
"""


def seeded(dev, seed):
    return torch.Generator(dev).manual_seed(seed)


def rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def free_service(scene, ctrl, dev, seed):
    """The service with every gate open: each full window is decided."""
    return ProactiveGreetingService(
        ServiceConfig(trigger_threshold=0.0, wakeup_cooldown_s=0.0,
                      near_field_frac=0.0), scene, ctrl,
        generator=seeded(dev, seed), device=dev)


# --- serving -------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving(cuda):
    """YOLOv4 at 416² and the 317-action controller (generator seeded 1),
    the serving frames (numpy seeded 1), the 12 frames' decisions through
    the kernel after a warm-up pass, and their attention launches."""
    rng = np.random.default_rng(1)
    gen = seeded(cuda, 1)
    scene = SceneSensor(input_size=SIZE, device=cuda, generator=gen)
    ctrl = AttentionController(AttnCtrlConfig(num_actions=317), device=cuda,
                               generator=gen)
    frames = rng.random((FRAMES, SIZE, SIZE, 3), dtype=np.float32)
    steady = rng.random((STEADY_FRAMES, SIZE, SIZE, 3), dtype=np.float32)
    windows = rng.standard_normal((N_WINDOWS, F_, K_, 562)).astype(np.float32)
    valid = rng.random((N_WINDOWS, F_, K_)) > 0.3

    def serve():
        svc = free_service(scene, ctrl, cuda, 2)
        return [svc.process_frame(img) for img in frames]

    serve()                             # warm-up: cuDNN, cuBLAS, allocator
    torch.cuda.synchronize()
    attention.flash_attention.launches = 0
    decisions = serve()
    torch.cuda.synchronize()
    return (scene, ctrl, frames, steady, (windows, valid), serve, decisions,
            attention.flash_attention.launches)


def test_serving_six_launches_per_decided_frame(serving):
    decisions, launches = serving[6:]
    decided = decisions[F_ - 1:]
    assert launches == 6 * len(decided) == 18
    assert all(np.isfinite([d.get("trigger_score", float("nan"))
                            for d in decided]))


def test_serving_matches_plain_attention(serving, monkeypatch):
    """The same 12 frames through ``reference_attention``: the same
    reasons and triggers, trigger scores and targets within SERVE_TOL."""
    serve, decisions = serving[5:7]
    monkeypatch.setattr(attention, "flash_attention",
                        attention.reference_attention)
    plain = serve()
    assert len(plain) == len(decisions)
    for a, b in zip(decisions, plain):
        assert a.get("reason") == b.get("reason")
        assert a["triggered"] == b["triggered"]
        if "trigger_score" in a:
            assert abs(a["trigger_score"] - b["trigger_score"]) <= SERVE_TOL
        if a["triggered"] and b["triggered"]:
            assert np.allclose(a["target_bbox"], b["target_bbox"],
                               atol=SERVE_TOL)


def test_steady_serving_decides_every_frame(cuda, serving):
    """Once the window is full, 50 frames: each decided, 6 launches each."""
    scene, ctrl, frames, steady = serving[:4]
    svc = free_service(scene, ctrl, cuda, 2)
    for img in frames[:F_]:
        svc.process_frame(img)
    attention.flash_attention.launches = 0
    scores = [svc.process_frame(img).get("trigger_score", float("nan"))
              for img in steady]
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == 6 * STEADY_FRAMES
    assert all(np.isfinite(scores))


def test_score_windows_matches_plain_attention(cuda, serving, monkeypatch):
    from paddlerobotics_torch.hri.eval_client import OfflineEvaluator

    scene, ctrl, _, _, (windows, valid) = serving[:5]
    ev = OfflineEvaluator(free_service(scene, ctrl, cuda, 2))
    s_kernel = ev.score_windows(windows, valid)
    monkeypatch.setattr(attention, "flash_attention",
                        attention.reference_attention)
    s_plain = ev.score_windows(windows, valid)
    assert np.isfinite(s_kernel).all()
    assert np.abs(s_kernel - s_plain).max() <= SERVE_TOL


# --- training ------------------------------------------------------------------

@pytest.fixture(scope="module")
def hri_trained(cuda):
    """200 ``train_step``s at batch 16 on ``generate_windows_device``
    windows (the plain attention: no launch), then one ``eval_step`` on 256
    held-out numpy windows; the launches of each, the mean losses of the
    first and last 20 steps, the trained state."""
    from paddlerobotics_torch.hri import synthetic_scene
    from paddlerobotics_torch.hri.train_attention import (AttentionTrainer,
                                                          to_device)

    cfg = AttnCtrlConfig(num_actions=317)
    trainer = AttentionTrainer(cfg, lr=HRI_LR, weight_decay=HRI_L2,
                               device=cuda)
    protos = synthetic_scene.device_prototypes(cfg, device=cuda)
    heldout = to_device(synthetic_scene.generate_windows(
        np.random.RandomState(0), HRI_HELDOUT, cfg), cuda)
    state = trainer.init(seeded(cuda, 0))
    gen = seeded(cuda, 1)
    losses = []
    attention.flash_attention.launches = 0
    for _ in range(HRI_TRAIN_STEPS):
        b = synthetic_scene.generate_windows_device(gen, HRI_BATCH, cfg,
                                                    protos, device=cuda)
        aux = trainer.train_step(state, b)
        losses.append(torch.stack([aux["loss"], aux["trigger_loss"]]))
    torch.cuda.synchronize()
    train_launches = attention.flash_attention.launches
    losses = torch.stack(losses).cpu().numpy()
    attention.flash_attention.launches = 0
    trainer.eval_step(state, heldout)
    eval_launches = attention.flash_attention.launches
    return (cfg, trainer, protos, heldout, state, losses, train_launches,
            eval_launches)


def outputs(trainer, model, batch, use_kernel):
    with torch.no_grad():
        return model(trainer._tokens(batch), batch["frame_ids"],
                     batch["padding_mask"], use_kernel=use_kernel)


def test_hri_train_runs_plain_attention_and_the_loss_falls(hri_trained):
    cfg, losses, train_launches, eval_launches = (hri_trained[0],
                                                  *hri_trained[5:])
    assert train_launches == 0
    assert eval_launches == cfg.num_decoder_blocks      # one a block: 6
    first, last = losses[:HRI_LOSS_WINDOW].mean(0), \
        losses[-HRI_LOSS_WINDOW:].mean(0)
    assert np.isfinite(losses).all()
    assert last[0] < first[0]


def test_trained_controller_through_the_kernel_matches_plain(hri_trained):
    _, trainer, _, heldout, state = hri_trained[:5]
    kern = outputs(trainer, state.model, heldout, True)
    plain = outputs(trainer, state.model, heldout, False)
    for k in ("trigger_logits", "obj_logits", "act_logits"):
        assert torch.isfinite(kern[k]).all()
        torch.testing.assert_close(kern[k], plain[k], atol=SERVE_TOL,
                                   rtol=SERVE_TOL)


def test_hri_train_resume_matches_the_uninterrupted_run(cuda, hri_trained,
                                                        tmp_path):
    """10 steps, save, restore into a fresh state, 10 more: within
    HRI_RESUME_TOL of 20 steps in one go, the step and Adam's counts
    equal."""
    from paddlerobotics_torch.hri import synthetic_scene
    from paddlerobotics_torch.train import checkpoints

    cfg, trainer, protos = hri_trained[:3]
    rgen = seeded(cuda, 2)
    batches = [synthetic_scene.generate_windows_device(
        rgen, HRI_BATCH, cfg, protos, device=cuda)
        for _ in range(2 * HRI_RESUME_STEPS)]
    whole = trainer.init(seeded(cuda, 3))
    part = trainer.init(seeded(cuda, 3))
    for b in batches:
        trainer.train_step(whole, b)
    for b in batches[:HRI_RESUME_STEPS]:
        trainer.train_step(part, b)
    ck = checkpoints.save_attn(str(tmp_path), part)
    resumed = trainer.init(seeded(cuda, 4))
    checkpoints.load_attn_state(resumed,
                                checkpoints.restore(ck, device=cuda)["attn"])
    for b in batches[HRI_RESUME_STEPS:]:
        trainer.train_step(resumed, b)
    torch.cuda.synchronize()
    assert max((p - q).abs().max().item() for p, q in zip(
        whole.model.parameters(), resumed.model.parameters())
               ) <= HRI_RESUME_TOL
    assert resumed.step == whole.step
    assert {float(resumed.opt.state[p]["step"])
            for p in resumed.model.parameters()} == {float(whole.step)}


def test_ablation_fleet_trains_every_variant(cuda, tmp_path):
    from paddlerobotics_torch.cli import parallel_train_attn

    attention.flash_attention.launches = 0
    fleet = parallel_train_attn.main([
        "--variants", ",".join(parallel_train_attn.VARIANTS),
        "--synthetic", str(HRI_FLEET_BATCHES), "--epochs", "1",
        "--outdir", str(tmp_path), "--device", "cuda"])
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == 0
    assert list(fleet) == list(parallel_train_attn.VARIANTS)
    for name, v in fleet.items():
        assert v["state"].step == HRI_FLEET_BATCHES
        assert (tmp_path / name / f"itr_{HRI_FLEET_BATCHES}.pt").exists()
        assert all(torch.isfinite(p).all()
                   for p in v["state"].model.parameters())


def test_exported_bundle_serves_the_trained_controller(cuda, serving,
                                                       hri_trained, tmp_path):
    """checkpoint → ``cli.export_hri_model`` → ``load_bundle``: the bundle's
    controller 0.0 from the trained module; the service on it with the
    YOLOv4 sensor decides 20 frames, 6 launches each."""
    from paddlerobotics_torch.cli import export_hri_model
    from paddlerobotics_torch.hri import export
    from paddlerobotics_torch.train import checkpoints

    scene = serving[0]
    cfg, trainer, _, heldout, state = hri_trained[:5]
    ck = checkpoints.save_attn(str(tmp_path / "train"), state)
    export_hri_model.main(["--ckpt", ck, "--out", str(tmp_path / "bundle")])
    bundle = export.load_bundle(str(tmp_path / "bundle"), device=cuda)
    one = {k: v[:1] for k, v in heldout.items()}
    a = outputs(trainer, state.model, one, True)
    b = outputs(trainer, bundle.ctrl, one, True)
    for k in ("trigger_logits", "obj_logits", "act_logits"):
        assert torch.equal(a[k], b[k])
    svc = free_service(scene, bundle.ctrl, cuda, 5)
    frames = np.random.default_rng(7).random(
        (HRI_BUNDLE_FRAMES + 9, SIZE, SIZE, 3), dtype=np.float32)
    attention.flash_attention.launches = 0
    decided = [d for d in (svc.process_frame(f) for f in frames)
               if "trigger_score" in d]
    torch.cuda.synchronize()
    assert len(decided) == HRI_BUNDLE_FRAMES
    assert attention.flash_attention.launches == \
        cfg.num_decoder_blocks * HRI_BUNDLE_FRAMES
    assert all(np.isfinite(d["trigger_score"]) for d in decided)


# --- tracking and transport ------------------------------------------------------

@pytest.fixture(scope="module")
def yolov3(cuda):
    """The YOLOv3 sensor at 416² (seeded 20), the 317-action controller
    (seeded 21) and 12 frames (numpy seeded 8)."""
    scene3 = SceneSensor(input_size=SIZE, arch="yolov3", device=cuda,
                         generator=seeded(cuda, 20))
    ctrl = AttentionController(AttnCtrlConfig(num_actions=317), device=cuda,
                               generator=seeded(cuda, 21))
    frames = np.random.default_rng(8).random((FRAMES, SIZE, SIZE, 3),
                                             dtype=np.float32)
    return scene3, ctrl, frames


@pytest.fixture(scope="module")
def reid(cuda):
    from paddlerobotics_torch.hri.perception.reid import MarsSmall128

    return MarsSmall128(device=cuda, generator=seeded(cuda, 27))


@pytest.fixture(scope="module")
def walkers(cuda):
    """A 100-frame 360×640 clip of 5 walkers, seeded 9."""
    return walker_clip(cuda, TRACK_FRAMES, 5, 20, 9)


def test_yolov3_sensor_serves_the_controller(cuda, yolov3):
    scene3, ctrl, frames = yolov3
    img = torch.as_tensor(frames[0], device=cuda)[None]
    inst = scene3.get_instances_with_feats(img)
    svc = free_service(scene3, ctrl, cuda, 22)
    attention.flash_attention.launches = 0
    decided = [d for d in (svc.process_frame(f) for f in frames)
               if "trigger_score" in d]
    torch.cuda.synchronize()
    assert tuple(inst.tokens.shape) == (1, 20, 562)
    assert torch.isfinite(inst.tokens).all()
    assert attention.flash_attention.launches == 6 * len(decided) == 18
    assert all(np.isfinite(d["trigger_score"]) for d in decided)


def test_darknet_sensor_weights_round_trip(cuda, yolov3):
    """A cfg-built sensor with perturbed BatchNorm statistics: its
    ``.weights`` written and read into a fresh sensor give the same
    instances, and the blob holds exactly the convolutions' floats."""
    from paddlerobotics_torch.hri.perception import darknet
    from paddlerobotics_torch.hri.perception.scene import DarknetSceneSensor

    img = torch.as_tensor(yolov3[2][0], device=cuda)[None]
    sections = darknet.parse_cfg(DARKNET_CFG)
    dn = DarknetSceneSensor(sections, device=cuda,
                            generator=seeded(cuda, 23))
    with torch.no_grad():                       # BatchNorm statistics too
        for m in dn.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t in (m.weight, m.running_var):
                    t.uniform_(0.5, 1.5, generator=seeded(cuda, 24))
                for t in (m.bias, m.running_mean):
                    t.normal_(0.0, 0.1, generator=seeded(cuda, 25))
    blob = darknet.save_darknet_weights(dn.model, sections)
    dn2 = DarknetSceneSensor(sections, device=cuda,
                             generator=seeded(cuda, 26))
    darknet.load_darknet_weights(dn2.model, sections, blob)
    a = dn.get_instances_with_feats(img)
    b = dn2.get_instances_with_feats(img)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (len(blob) - 20) // 4 == sum(
        getattr(dn.model, f"conv{li}").weight.numel()
        + getattr(dn.model, f"conv{li}").out_channels * (4 if bn else 1)
        for li, bn in darknet._conv_layers(sections))
    assert tuple(a.tokens.shape) == (1, 20, 562)
    assert torch.isfinite(a.tokens).all()


def test_reid_unit_norms_and_the_cpu(cuda, reid):
    from paddlerobotics_torch.hri.perception.reid import MarsSmall128

    crops = torch.rand((20, 128, 64, 3), generator=seeded(cuda, 28),
                       device=cuda)
    with torch.no_grad():
        feats = reid(crops)
        on_cpu = MarsSmall128(device="cpu").eval()
        on_cpu.load_state_dict({k: v.cpu()
                                for k, v in reid.state_dict().items()})
        d_cpu = (feats.cpu() - on_cpu(crops.cpu())).abs().max().item()
    assert tuple(feats.shape) == (20, 128)
    assert (feats.norm(dim=-1) - 1).abs().max().item() < 1e-5
    assert d_cpu < REID_TOL


def test_tracker_and_track_frames_one_launch_per_frame(cuda, yolov3, reid,
                                                       walkers, monkeypatch):
    """The tracker on the clip's boxes: the 5 walkers keep their ids, one
    ``track_match`` launch per frame; ``track_frames`` with YOLOv3 and the
    re-ID encoder: one launch per frame, and its first 30 frames through
    the plain matching on the host give the same logs."""
    from paddlerobotics_torch.cli import collect_data
    from paddlerobotics_torch.hri import tracker as trk

    scene3 = yolov3[0]
    clip, wboxes, wfeats, wvalid = walkers
    state = trk.init_tracker(cuda)
    ids = []
    lap.track_match.launches = 0
    for f in range(TRACK_FRAMES):
        state = trk.tracker_predict(state)
        state, tid = trk.tracker_update(state, wboxes[f], wfeats[f],
                                        wvalid[f])
        ids.append(tid[:5])
    ids = torch.stack(ids).cpu().numpy()
    assert lap.track_match.launches == TRACK_FRAMES
    assert all(len(set(ids[4:, k])) == 1 and ids[-1, k] > 0
               for k in range(5))
    assert len(set(ids[-1])) == 5

    collect_data.track_frames(clip[:2], scene3, reid)         # warm-up
    lap.track_match.launches = 0
    logs_k = collect_data.track_frames(clip, scene3, reid)
    assert lap.track_match.launches == TRACK_FRAMES
    monkeypatch.setattr(lap, "track_match", lambda *a: tuple(
        t.to(cuda) for t in lap.track_match_plain(
            *[x.cpu() for x in a[:5]], *a[5:8])))
    logs_p = collect_data.track_frames(clip[:TRACK_PLAIN_FRAMES], scene3,
                                       reid)
    assert logs_k[:TRACK_PLAIN_FRAMES] == logs_p


def test_grpc_handlers_answer_as_the_service_on_letterboxed_frames(
        cuda, yolov3, walkers, tmp_path):
    """``cli.serve_grpc``'s transport-free handlers on a bundle with the
    YOLOv3 sensor: 20 uint8 BGR 360×640 ``VideoRequest``s give the
    service's decisions on the frames letterboxed by ``hri/utils`` (6
    launches per decided frame), one 10-frame ``EvalRequest`` the last
    frame's decision (6 launches)."""
    import json

    from paddlerobotics_torch.cli import serve_grpc
    from paddlerobotics_torch.hri import export
    from paddlerobotics_torch.hri import grpc_transport as gt
    from paddlerobotics_torch.hri import pg_proto as pb
    from paddlerobotics_torch.hri.utils import letterbox_image

    scene3, ctrl, _ = yolov3
    clip = walkers[0]
    export.save_bundle(str(tmp_path), ctrl.cfg, ctrl.state_dict(),
                       scene=scene3, extra={"trigger_threshold": 0.0})
    process, score_clip, _ = serve_grpc.build_services(
        serve_grpc.build_parser().parse_args(
            ["--bundle", str(tmp_path), "--device", cuda.type]))
    greet = gt.greeting_handler(process, device=cuda)
    evalh = gt.eval_handler(score_clip, device=cuda)
    views = clip[:GRPC_FRAMES].flip(-1).cpu().numpy()      # uint8 BGR
    attention.flash_attention.launches = 0
    got = [json.loads(pb.InferResponse.decode(greet(pb.VideoRequest(
        req_id=i, cur_frame=v.tobytes()).encode())).response)
        for i, v in enumerate(views)]
    grpc_launches = attention.flash_attention.launches
    assert [d.pop("req_id") for d in got] == list(range(GRPC_FRAMES))
    ref_cfg = ServiceConfig(num_frames=ctrl.cfg.num_frames,
                            tokens_per_frame=ctrl.cfg.tokens_per_frame,
                            trigger_threshold=0.0)
    lb = lambda v: letterbox_image(torch.as_tensor(
        np.ascontiguousarray(v[..., ::-1]), device=cuda).to(torch.float32)
        / 255.0)
    ref_svc = ProactiveGreetingService(ref_cfg, scene3, ctrl, device=cuda)
    assert got == [ref_svc.process_frame(lb(v)) for v in views]
    decided = sum("trigger_score" in d for d in got)
    assert decided == GRPC_FRAMES - 9
    assert grpc_launches == 6 * decided
    stack = views[:GRPC_EVAL_FRAMES]
    attention.flash_attention.launches = 0
    ev = pb.EvalResponse.decode(evalh(pb.EvalRequest(
        nframe=len(stack), frames=stack.tobytes()).encode()))
    assert attention.flash_attention.launches == 6
    eval_svc = ProactiveGreetingService(ref_cfg, scene3, ctrl, device=cuda)
    last = [eval_svc.process_frame(lb(v)) for v in stack][-1]
    assert ev.trigger_pred == float(np.float32(last["trigger_score"]))
    assert json.loads(ev.response) == last


# --- the native runtime ----------------------------------------------------------

@pytest.fixture(scope="module")
def native(cuda):
    """The C++ runtime's library, ``serving_bench``'s YOLOv4 + 317-action
    service and callbacks (seed 4), 10 frames (numpy seeded 4), warmed up
    with the window full."""
    from paddlerobotics_torch.cli import serving_bench
    from paddlerobotics_torch.ops.build import build_native_runtime

    lib, _ = build_native_runtime()
    svc, cbs = serving_bench.build_models(317, device=cuda, seed=4)
    rng = np.random.default_rng(4)
    frames = [rng.random((SIZE, SIZE, 3), dtype=np.float32)
              for _ in range(NATIVE_EVAL_FRAMES)]
    for f in frames + frames[:2]:
        svc.process_frame(f)
    cbs.detect(frames[0])
    return lib, svc, cbs, frames


def test_native_eval_server_matches_the_controller_in_process(cuda, native):
    """5 requests of 10 frames through ``NativeEvalServer``: scores within
    NATIVE_TOL and ids equal to the same window through the sensor and the
    controller here on the generator's saved state, 6 launches each; the
    handle's ``check()`` raises nothing."""
    from paddlerobotics_torch.hri.attention_ctrl import top_k_sampling
    from paddlerobotics_torch.hri.native_pipeline import NativeEvalServer
    from paddlerobotics_torch.hri.stream_client import EvalStreamClient

    lib, svc, cbs, frames = native
    scene, ctrl = svc.scene, svc.ctrl
    server = NativeEvalServer(cbs.detect, cbs.attend, num_act=317,
                              trigger_threshold=0.0, near_field_frac=0.0,
                              lib_path=lib)
    client = EvalStreamClient(port=server.port)
    fids = torch.arange(1, 11, device=cuda).repeat_interleave(20)[None]
    try:
        for r in range(NATIVE_EVAL_REQUESTS):
            req = frames[r:] + frames[:r]
            state = cbs.generator.get_state()
            attention.flash_attention.launches = 0
            out = client.infer(req)
            assert attention.flash_attention.launches == 6
            with torch.no_grad():
                inst = [scene.get_instances_with_feats(torch.as_tensor(
                    f, device=cuda)[None]) for f in req]
                tok = torch.cat([i.tokens for i in inst]).reshape(1, 200, -1)
                pad = torch.cat([i.valid for i in inst]).reshape(
                    1, 200).to(torch.float32)
                o = ctrl({"visual_tokens": tok}, fids, pad, use_kernel=True)
                logits = o["act_logits"][:, -1:, :]
                g = torch.Generator(cuda)
                g.set_state(state)
                ref_id = int(top_k_sampling(logits, 1.0, 5, generator=g)[0, 0])
                ref_trig = float(torch.sigmoid(o["trigger_logits"][0, -1]))
                ref_acts = torch.softmax(logits[0, 0], -1).cpu().numpy()
            # with no valid detection in the last frame C++ answers
            # no_target, and the response score stays 0
            resp = out["response"]
            want = ref_acts[ref_id] if resp["triggered"] else 0.0
            assert resp.get("action_id", ref_id) == ref_id
            assert out["nullact_id"] == int(ref_acts.argmax())
            assert max(abs(out["trigger_pred"] - ref_trig),
                       abs(out["nullact_score"] - ref_acts[0]),
                       abs(out["response_score"] - want),
                       float(np.abs(cbs.last["act_scores"] - ref_acts).max())
                       ) <= NATIVE_TOL
        server.check()
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["stream_sync", "stream_pipelined"])
def test_native_stream_arm_six_launches_per_attend(native, pipelined):
    from paddlerobotics_torch.cli import serving_bench

    lib, svc, cbs, frames = native
    pace_s = 1.5 * serving_bench.arm_model_sync(
        svc, frames, 12)["p50_ms"] / 1e3 + 0.05
    attention.flash_attention.launches = 0
    row = serving_bench.arm_stream(cbs, frames, NATIVE_STREAM_FRAMES,
                                   pipelined=pipelined, pace_s=pace_s,
                                   lib_path=lib)
    assert attention.flash_attention.launches == 6 * row["attend_calls"]
    assert row["decisions"] > 0
    assert row["attend_calls"] >= row["decisions"]


def test_native_clip_server_matches_a_direct_model_call(cuda, native):
    """R(2+1)D-18 behind ``NativeClipEvalServer`` on 5 clips: the scores of
    the clip C++ preprocessed within CLIP_TOL of a direct model call."""
    from paddlerobotics_torch.hri.native_pipeline import (
        CLIP_LEN, CLIP_RES, NativeClipEvalServer)
    from paddlerobotics_torch.hri.r2plus1d import R2Plus1D18
    from paddlerobotics_torch.hri.r2plus1d_train import (ClipScorer,
                                                         make_inference_fn)
    from paddlerobotics_torch.hri.stream_client import EvalStreamClient

    lib, _, _, frames = native
    model = R2Plus1D18(317, device=cuda, generator=seeded(cuda, 5)).eval()
    scorer = ClipScorer(model, generator=seeded(cuda, 6))
    seen = []

    def score(clip):
        out = scorer(clip)
        seen.append((clip, out[0]))
        return out

    scorer(np.zeros((CLIP_LEN, 3, CLIP_RES, CLIP_RES), np.float32))  # warm
    server = NativeClipEvalServer(score, 317, lib_path=lib)
    client = EvalStreamClient(port=server.port)
    infer = make_inference_fn(model)
    try:
        for r in range(CLIP_REQUESTS):
            out = client.infer(frames[r:] + frames[:r])
            clip, probs = seen[-1]
            x = torch.as_tensor(clip, device=cuda).permute(1, 0, 2, 3)[None]
            ref = infer(x, 1.0, 5, noise=torch.zeros(1, 317, device=cuda))[0]
            ref = ref[0].cpu().numpy()
            assert np.abs(probs - ref).max() <= CLIP_TOL
            assert abs(out["nullact_score"] - ref[0]) <= CLIP_TOL
            assert out["nullact_id"] == int(ref.argmax())
        server.check()
    finally:
        client.close()
        server.close()
    assert len(seen) == CLIP_REQUESTS


def test_backbones_match_the_cpu(cuda):
    """MobileNetV2 and ResNet-50 at 224² on the card against the CPU,
    within BACKBONE_RTOL of the output's scale."""
    from paddlerobotics_torch.hri.perception.backbones import (MobileNetV2,
                                                               ResNet)

    g = seeded(cuda, 7)
    x = torch.rand(2, 3, 224, 224, generator=g, device=cuda)
    for net in (MobileNetV2(device=cuda, generator=g),
                ResNet(device=cuda, generator=g)):
        with torch.no_grad():
            out = net(x)
            out = out if isinstance(out, tuple) else (out,)
            cpu = copy.deepcopy(net).cpu()(x.cpu())
            cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        assert all(torch.isfinite(a).all() for a in out)
        assert max(rel(a.cpu(), b) for a, b in zip(out, cpu)) <= BACKBONE_RTOL


def test_reid_through_a_frozen_graph_is_the_encoder(cuda):
    """The re-ID encoder with perturbed BatchNorm statistics, exported to a
    frozen graph and imported back: the same features, 0.0 apart."""
    from paddlerobotics_torch.hri.perception import reid, tf_graph

    g = seeded(cuda, 7)
    enc = reid.MarsSmall128(device=cuda, generator=g)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g,
                                                       device=cuda))
                m.running_var.copy_(0.8 + 0.4 * torch.rand(n, generator=g,
                                                           device=cuda))
    imported = reid.import_tf_consts(tf_graph.parse_graph_consts(
        tf_graph.encode_const_graph(reid.export_tf_consts(enc))), device=cuda)
    crops = torch.rand(20, 128, 64, 3, generator=g, device=cuda)
    with torch.no_grad():
        a, b = imported(crops), enc(crops)
    assert torch.equal(a, b)
    assert (b[0] - b[1]).abs().max().item() > 1e-3


# --- the data tools ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ernie_run(cuda):
    """The full-width ERNIE encoder over the 317-row catalog padded to 64
    tokens, through the kernel (its launches counted) and the plain
    attention."""
    _, model, catalog, ids = ernie(cuda)
    with torch.no_grad():
        model(ids)                                   # warm-up
        torch.cuda.synchronize()
        attention.flash_attention.launches = 0
        seq_k, pool_k = model(ids)
        torch.cuda.synchronize()
        launches = attention.flash_attention.launches
        seq_p, pool_p = model(ids, use_kernel=False)
    return model.cfg, catalog, launches, (seq_k, pool_k), (seq_p, pool_p)


def test_ernie_through_the_kernel_matches_plain(ernie_run):
    ecfg, _, launches, (seq_k, pool_k), (seq_p, pool_p) = ernie_run
    assert launches == ecfg.num_layers
    assert rel(seq_k, seq_p) <= ERNIE_TOL
    assert rel(pool_k, pool_p) <= ERNIE_TOL
    assert torch.isfinite(pool_k).all()


@pytest.fixture(scope="module")
def act_tables(cuda, ernie_run, tmp_path_factory):
    """``cli.collect_act_emb`` with ERNIE and with BoW on the catalog: each
    table and its attention launches."""
    from paddlerobotics_torch.cli import collect_act_emb

    catalog = ernie_run[1]
    out = tmp_path_factory.mktemp("act_emb")
    (out / "acts.tsv").write_text("".join("\t".join(r) + "\n"
                                          for r in catalog))
    tables = {}
    for encoder in ("ernie", "bow"):
        attention.flash_attention.launches = 0
        tab = collect_act_emb.main([
            "--catalog", str(out / "acts.tsv"), "--out",
            str(out / f"{encoder}.npy"), "--encoder", encoder, "--seed", "0"])
        tables[encoder] = (tab, attention.flash_attention.launches)
    return out, tables


@pytest.mark.parametrize("encoder", ["ernie", "bow"])
def test_collect_act_emb(ernie_run, act_tables, encoder):
    from paddlerobotics_torch.hri import actions

    ecfg, catalog = ernie_run[:2]
    tab, launches = act_tables[1][encoder]
    onehot = np.stack([actions.MultimodalAction(*r).one_hot()
                       for r in catalog])
    assert tab.shape == (ERNIE_ROWS, 12 + 30 + 768)
    assert np.isfinite(tab).all()
    assert np.array_equal(tab[:, :42], onehot)
    assert launches == (ecfg.num_layers if encoder == "ernie" else 0)


def test_loader_into_training_and_the_table_into_the_bundle(cuda, serving,
                                                            act_tables):
    """``WindowSampler`` → ``PrefetchLoader`` with the YOLOv4
    ``WindowTokenizer`` → 3 ``AttentionTrainer`` steps at batch 16 (no
    attention launch); a failing sample raised from the loader within a
    second; the checkpoint exported with the ERNIE table
    (``export_hri_model --wae``) and loaded back, the table 0.0 apart."""
    import time

    from paddlerobotics_torch.cli import export_hri_model
    from paddlerobotics_torch.hri import data, export
    from paddlerobotics_torch.hri.train_attention import AttentionTrainer
    from paddlerobotics_torch.train import checkpoints

    scene = serving[0]
    out, tables = act_tables
    cfg = AttnCtrlConfig(num_actions=ERNIE_ROWS)
    trainer = AttentionTrainer(cfg, lr=HRI_LR, weight_decay=HRI_L2,
                               device=cuda)
    state = trainer.init(seeded(cuda, 31))
    moments = [data.AnnotatedMoment(f"clip_{i:03d}.mp4", 20 + 7 * i,
                                    i % ERNIE_ROWS) for i in range(64)]
    sampler = data.WindowSampler(moments, num_frames=cfg.num_frames, seed=0)
    sampler.add_negatives(moments[::4])
    fgen = seeded(cuda, 32)

    def synthetic_frames(video, idx):
        return torch.rand((len(idx), SIZE, SIZE, 3), generator=fgen,
                          device=cuda)

    tok = data.WindowTokenizer(scene, read_frames=synthetic_frames,
                               device=cuda)
    loader = data.PrefetchLoader(sampler.sample, tok, HRI_BATCH)
    it = iter(loader)
    trainer.train_step(state, next(it))          # warm-up batch
    torch.cuda.synchronize()
    attention.flash_attention.launches = 0
    losses = [float(trainer.train_step(state, next(it))["loss"])
              for _ in range(HRI_DATA_STEPS)]
    loader.close()
    assert all(np.isfinite(losses))
    assert attention.flash_attention.launches == 0
    assert not loader._thread.is_alive()

    def failing():
        raise ValueError("synthetic decode failure")

    bad = data.PrefetchLoader(failing, tok, 2)
    t = time.perf_counter()
    with pytest.raises(ValueError, match="^synthetic decode failure$"):
        next(iter(bad))
    assert time.perf_counter() - t < 1.0
    bad.close()
    assert not bad._thread.is_alive()

    ck = checkpoints.save_attn(str(out / "train"), state)
    export_hri_model.main(["--ckpt", ck, "--out", str(out / "bundle"),
                           "--wae", str(out / "ernie.npy")])
    bundle = export.load_bundle(str(out / "bundle"), device=cuda)
    assert np.array_equal(bundle.wae, tables["ernie"][0])


def test_salutation_heads_match_the_cpu(cuda, serving, ernie_run):
    """``SalutationClsTree`` on the YOLOv4 sensor's features and
    ``DiscreteController`` on ERNIE's pooled catalog, card against CPU."""
    from paddlerobotics_torch.hri import actions

    scene = serving[0]
    feat = ernie_run[3][1]                                   # (317,768)
    img = torch.rand((2, SIZE, SIZE, 3), generator=seeded(cuda, 33),
                     device=cuda)
    fm = scene.get_instances_with_feats(img).feats          # (2,K,5,5,512)
    tree = actions.SalutationClsTree(fm.shape[-1], device=cuda,
                                     generator=seeded(cuda, 34))
    tree_cpu = actions.SalutationClsTree(fm.shape[-1], device="cpu")
    tree_cpu.load_state_dict(tree.state_dict())
    ctrl = actions.DiscreteController(feat.shape[-1],
                                      actions.action_set_size(), (256,),
                                      device=cuda, generator=seeded(cuda, 35))
    ctrl_cpu = actions.DiscreteController(feat.shape[-1],
                                          actions.action_set_size(), (256,),
                                          device="cpu")
    ctrl_cpu.load_state_dict(ctrl.state_dict())
    with torch.no_grad():
        t_card, t_cpu = tree(fm), tree_cpu(fm.cpu())
        c_card, c_cpu = ctrl(feat), ctrl_cpu(feat.cpu())
    assert t_card.shape == fm.shape[:2] + (6,)
    assert rel(t_card.cpu(), t_cpu) <= BACKBONE_RTOL
    assert rel(c_card.cpu(), c_cpu) <= BACKBONE_RTOL
