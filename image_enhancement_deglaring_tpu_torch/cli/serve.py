"""Serving CLI: the HTTP API backed by the batched engine on the GPU
(replaces `uvicorn api.app:app`, reference: api/app.py:221-222).

    python -m image_enhancement_deglaring_tpu_torch.cli.serve \
        [--model_path deploy/models/best_model.onnx] [--port 4000] \
        [--mode resize|tile|both] [--data_parallel [N]] [--device cuda]

The same flags and defaults as the JAX CLI, plus ``--device`` (default
``cuda``; without a card that raises unless ``--device cpu`` is given).
``--data_parallel [N]`` serves over N local cards (every card without N;
clamped to the cards there are) from this one process: one model replica
per card, each batch split over them (``parallel.mesh.LocalMesh``).
``--workers N`` runs N HTTP worker processes (``serve.ipc``) in front of
the engine that this process owns. Usage errors fail before the model
loads.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve the de-glaring model over HTTP")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=4000)
    # MODEL_PATH env wires the k8s ConfigMap (deploy/k8s/model-configmap.yaml)
    p.add_argument("--model_path", type=str,
                   default=os.environ.get("MODEL_PATH",
                                          "deploy/models/best_model.onnx"))
    p.add_argument("--mode", type=str, default="resize",
                   choices=["resize", "tile", "both"],
                   help="resize = reference-parity 512^2; tile = full-res "
                        "tiled; both = resize default with per-request "
                        "?mode=tile override")
    p.add_argument("--model", "--model_arch", dest="model", type=str, default="auto",
                   choices=["auto", "lightweight", "optimized", "enhanced", "restormer"],
                   help="model family of the checkpoint; auto detects from "
                        "the artifact")
    p.add_argument("--max_batch_size", type=int, default=8)
    p.add_argument("--batch_timeout_ms", type=float, default=3.0)
    p.add_argument("--tile_overlap", type=int, default=32)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="serve with int8 weights (per-output-channel PTQ)")
    p.add_argument("--image_size", type=int, default=512,
                   help="model input resolution (resize mode) / tile size")
    p.add_argument("--workers", type=int, default=1,
                   help="HTTP worker processes (SO_REUSEPORT) sharing one "
                        "engine process over IPC; scales the host-bound "
                        "PNG work across CPUs (resize mode only)")
    p.add_argument("--allow_reload", action="store_true",
                   help="expose POST /reload for zero-downtime weight swaps "
                        "from a same-family checkpoint on this filesystem")
    p.add_argument("--data_parallel", type=int, nargs="?", const=0,
                   default=None, metavar="N",
                   help="split request batches across N local devices (omit "
                        "N = every local device): one model replica per device, "
                        "batch buckets snap to multiples of N. Default: one device")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--profile_port", type=int, default=0,
                   help="profiler capture port (0 = off): GET "
                        "http://127.0.0.1:PORT/trace?ms=N traces this process for N ms")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on (cuda, or cpu)")
    return p.parse_args(argv)


def build_serving_mesh(data_parallel: int | None, max_batch_size: int, device="cuda"):
    """Resolve --data_parallel into (mesh, max_batch_size), as the JAX CLI.

    ``None`` = off; ``0`` = every local device; ``N`` = N devices (clamped
    to what exists, loudly). A resolved 1 serves on one device without a
    mesh. ``max_batch_size`` rounds UP to a mesh multiple (the engine
    requires divisibility)."""
    if data_parallel is None:
        return None, max_batch_size
    import torch

    from ..parallel.distributed import local_device_count
    from ..parallel.mesh import make_local_mesh

    avail = local_device_count(device, data_parallel)
    n = data_parallel or avail
    if n > avail:
        print(f"requested --data_parallel {n}, but only {avail} "
              f"device(s) available; using {avail}")
        n = avail
    if n <= 1:
        print("--data_parallel resolved to 1 device; serving single-chip")
        return None, max_batch_size
    snapped = -(-max_batch_size // n) * n
    if snapped != max_batch_size:
        print(f"--max_batch_size {max_batch_size} rounded up to {snapped} "
              f"(must be a multiple of the {n}-chip serving mesh)")
    return make_local_mesh(n, device=torch.device(device).type), snapped


def main(argv=None):
    args = parse_args(argv)
    # usage errors fail BEFORE create_server loads the model and builds
    # the kernels
    if args.workers > 1:
        if args.mode != "resize":
            raise SystemExit("--workers > 1 requires --mode resize")
        if args.allow_reload:
            # worker processes proxy frames only; /reload would 404 on them
            raise SystemExit("--allow_reload requires --workers 1 "
                             "(the engine process owns the weights)")
    import torch

    from ..serve import create_server

    if args.profile_port:
        # before the model loads, so the warmup can be captured too; the
        # capture endpoint runs on a daemon thread of this process, the one
        # that owns the engine and launches its batches
        from ..utils.profiling import start_trace_server

        start_trace_server(args.profile_port)
        print(f"profiler captures on http://127.0.0.1:{args.profile_port}/trace?ms=N "
              f"(a *.pt.trace.json for TensorBoard / chrome://tracing)", flush=True)

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    mesh, max_batch = build_serving_mesh(args.data_parallel, args.max_batch_size, args.device)
    if mesh is not None:
        print(f"serving data-parallel over {mesh.size} chips "
              f"(batch buckets snap to multiples of {mesh.size})")
    server = create_server(
        args.model_path, host=args.host, port=args.port, mode=args.mode,
        model_arch=args.model, max_batch_size=max_batch,
        batch_timeout_ms=args.batch_timeout_ms, compute_dtype=dtype,
        tile_overlap=args.tile_overlap, log_dir=args.log_dir,
        image_size=args.image_size, quantize=args.quantize,
        allow_reload=args.allow_reload, mesh=mesh,
        device=args.device if mesh is None else None,
    )
    if args.workers > 1:
        import signal
        import threading

        from ..serve.ipc import serve_multiprocess

        server.engine.start()
        mps = serve_multiprocess(
            server.engine, host=args.host, port=args.port,
            image_size=args.image_size, n_workers=args.workers,
            log_dir=args.log_dir, model_info=server.model_info,
        )
        # SIGTERM on the parent (k8s pod shutdown) forwards to the workers,
        # each of which drains its in-flight requests before exiting
        stop_evt = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop_evt.set())
        try:
            while not stop_evt.is_set() and mps.any_alive():
                stop_evt.wait(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            mps.stop()
            server.engine.stop()
        return
    try:
        server.run()
    except KeyboardInterrupt:
        pass
    finally:
        server.engine.stop()


if __name__ == "__main__":
    main()
