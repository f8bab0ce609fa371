"""Serve the proactive-greeting (bidi stream) and offline-eval (unary) gRPC
endpoints from a bundle (PyTorch port of the JAX package's
``cli/serve_grpc.py``), on the card unless ``--device`` says otherwise.

    python -m paddlerobotics_torch.cli.serve_grpc --bundle bundle/ \\
        [--port 9320] [--eval_port 9321] [--device cuda]

    # smoke mode: seeded random weights, no bundle needed
    python -m paddlerobotics_torch.cli.serve_grpc --smoke --steps 1

Every decided frame runs the attention controller through the attention
kernel (six launches on the card). ``build_services`` builds the two
decision functions without any transport; ``hri.grpc_transport``'s
handlers turn them into wire-bytes functions and its servers put those on
``grpcio``, which only the servers and the ``--steps`` loopback need.
"""

from __future__ import annotations

import argparse
import json
import threading
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--bundle", type=str, default="",
                   help="cli/export_hri_model bundle dir")
    p.add_argument("--smoke", action="store_true",
                   help="seeded random weights (no bundle): transport smoke")
    p.add_argument("--port", type=int, default=9320)
    p.add_argument("--eval_port", type=int, default=9321)
    p.add_argument("--arch", type=str, default="yolov4",
                   choices=("yolov4", "yolov3"),
                   help="the scene sensor where the bundle has none")
    p.add_argument("--trigger_threshold", type=float, default=-1.0,
                   help="<0 = use the bundle's exported threshold")
    p.add_argument("--actions", type=str, default="",
                   help="multimodal_actions.txt for the salutation "
                        "catalog")
    p.add_argument("--steps", type=int, default=0,
                   help=">0 = self-drive N loopback frames then exit "
                        "(smoke validation); 0 = serve forever")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def build_services(args):
    """The greeting and eval decision functions of ``args`` →
    (process(image, lag_ms, wakeup) -> dict, score_clip(frames) -> dict,
    device)."""
    import torch

    from paddlerobotics_torch.core.device import resolve_device
    from paddlerobotics_torch.hri import export as export_mod
    from paddlerobotics_torch.hri.attention_ctrl import (AttentionController,
                                                         AttnCtrlConfig)
    from paddlerobotics_torch.hri.perception.scene import SceneSensor
    from paddlerobotics_torch.hri.serving import (ProactiveGreetingService,
                                                  ServiceConfig)

    if not args.bundle and not args.smoke:
        raise SystemExit("pass --bundle DIR or --smoke")
    dev = resolve_device(args.device)

    def seeded(seed):
        g = torch.Generator(dev)
        g.manual_seed(seed)
        return g

    threshold = args.trigger_threshold
    scene = None
    if args.smoke:
        # tokens_per_frame is the scene sensor's MAX_INSTANCES (20)
        ctrl_cfg = AttnCtrlConfig(num_frames=4, tokens_per_frame=20,
                                  model_dim=64, num_decoder_blocks=1,
                                  num_heads=2, ffn_dim=128, num_actions=8)
        ctrl = AttentionController(ctrl_cfg, device=dev, generator=seeded(0))
        if threshold < 0:
            threshold = 0.0          # random weights: always trigger
    else:
        bundle = export_mod.load_bundle(args.bundle, device=dev)
        ctrl_cfg, ctrl, scene = bundle.ctrl_cfg, bundle.ctrl, bundle.scene
        if threshold < 0:
            threshold = float(bundle.manifest.get("extra", {}).get(
                "trigger_threshold", 0.8))
    if scene is None:
        scene = SceneSensor(arch=args.arch, device=dev, generator=seeded(1))

    catalog = None
    if args.actions:
        from paddlerobotics_torch.hri.actions import MultimodalAction

        catalog = []
        with open(args.actions) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if parts and parts[0]:
                    catalog.append(MultimodalAction(
                        *(parts + ["null"] * 4)[:4]))

    # the online stream and the offline endpoint each get their own
    # service: score_clip resets its windows, which must not touch a
    # concurrent greeting stream's; each is lock-guarded because the gRPC
    # servers run thread pools
    svc_cfg = ServiceConfig(num_frames=ctrl_cfg.num_frames,
                            tokens_per_frame=ctrl_cfg.tokens_per_frame,
                            trigger_threshold=threshold)
    svc = ProactiveGreetingService(svc_cfg, scene, ctrl,
                                   action_catalog=catalog, device=dev)
    eval_svc = ProactiveGreetingService(svc_cfg, scene, ctrl,
                                        action_catalog=catalog, device=dev)
    svc_lock, eval_lock = threading.Lock(), threading.Lock()

    def process(img, lag_ms, wakeup):
        with svc_lock:
            d = svc.process_frame(img, timestamp=time.time() - lag_ms / 1e3)
        if wakeup:
            d["wakeup"] = wakeup
        return d

    def score_clip(frames):
        """Window the clip's frames through the service from an empty
        window; report the last step's trigger."""
        with eval_lock:
            eval_svc.token_window.clear()
            eval_svc.valid_window.clear()
            eval_svc.box_window.clear()
            eval_svc.last_trigger_time = -1e9
            last = {}
            for f in frames:
                last = eval_svc.process_frame(f)
        return {"response": last, "response_score":
                float(last.get("target_obj_score", 0.0)),
                "trigger_pred": float(last.get("trigger_score", 0.0)),
                "nullact_id": int(last.get("action_id", 0))}

    return process, score_clip, dev


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from paddlerobotics_torch.hri.grpc_transport import (EvalGrpcServer,
                                                         GreetingGrpcServer)

    process, score_clip, dev = build_services(args)
    greet = GreetingGrpcServer(process, port=args.port, device=dev).start()
    evals = EvalGrpcServer(score_clip, port=args.eval_port,
                           device=dev).start()
    print(f"ProactiveGreeting.infer on 127.0.0.1:{greet.port} | "
          f"EvalServer.infer on 127.0.0.1:{evals.port}", flush=True)

    if args.steps > 0:
        from paddlerobotics_torch.hri.grpc_transport import (
            EvalGrpcClient, GreetingGrpcClient)

        try:
            c = GreetingGrpcClient(f"127.0.0.1:{greet.port}")
            reqs = [c.video_request(i, np.zeros((416, 416, 3), np.float32))
                    for i in range(args.steps)]
            for d in c.infer(iter(reqs)):
                print(json.dumps(d), flush=True)
            c.close()
            ec = EvalGrpcClient(f"127.0.0.1:{evals.port}")
            print(json.dumps(ec.infer(
                [np.zeros((416, 416, 3), np.float32)])), flush=True)
            ec.close()
        finally:
            greet.stop(0)
            evals.stop(0)
        return

    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        greet.stop(0)
        evals.stop(0)


if __name__ == "__main__":
    main()
