"""Serving entry point: `python -m rt1_tpu_torch.serve`.

Run (flagship config, random weights, on the card):

  python -m rt1_tpu_torch.serve --config language_table --random_init --port 8321

Run (the JAX package's weights, saved as an .npz of `/`-joined flax paths):

  python -m rt1_tpu_torch.serve --config language_table --weights params.npz

Run (what `python -m rt1_tpu_torch.train` wrote: its newest checkpoint):

  python -m rt1_tpu_torch.serve --config language_table --workdir /tmp/rt1_torch

Run (smoke config on the CPU):

  python -m rt1_tpu_torch.serve --config tiny --random_init --port 0 --device cpu

Serving modes: `--inference_dtype bf16|int8` (bf16 weights and compute;
int8 weights per output channel, dequantized at use),
`--cached_inference` (per-session K/V caches: a step runs the decoder over
the new frame only), `--session_snapshot_dir DIR` (an on-disk ring of
session snapshots that a replica restores on `/act`). `POST /reload`
swaps in the standby weights (the newest checkpoint of `--workdir`, the
`--weights` file, or the same random init); `--watch_checkpoints_s N`
polls `--workdir` and swaps in each newer checkpoint.

Observability and chaos, as the fleet drives them: `GET /metrics` answers
Prometheus text to `Accept: text/plain`; `GET /slow_requests` serves the
exemplar ring of requests at least `--slow_threshold_ms` slow, dumped to
`--exemplar_path` on drain; `RT1_FAULTS` arms the replica's fault sites
(`session_restore@N`, `capture_write@N`).

A `--workdir` whose `data_manifest.json` records another instruction
embedder than `--embedder` is refused unless `--allow_embedder_mismatch`.
`--capture_dir DIR` writes each served session as an episode `.npz` when
it is released, reset, terminated or drained (`flywheel/capture.py`).

The batcher takes JAX's flags: `--max_batch` (0 = `--max_sessions`, and
clamped to it), `--max_delay_ms`, `--max_queue`, `--pipeline_depth` and
`--request_timeout_s`; `/healthz` reports them under `batcher`.
`--verbose` logs a line per request.

Prints one JSON ready-line (`{"status": "serving", "port": ...}`) once every
bucket is warmed and the socket is bound, then serves until SIGTERM/SIGINT,
which drains accepted requests, prints a final `{"status": "drained", ...}`
line and exits 0. `--attention fused` (the default) runs the hand-written
attention kernel on the card; `--attention dense` the plain path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.serve", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True,
                   help="language_table | tiny (or the path of the JAX config file of that name)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--random_init", action="store_true",
                     help="Serve seeded random weights (no checkpoint needed).")
    src.add_argument("--weights", help="An .npz of the JAX package's variables.")
    src.add_argument("--workdir", help="A workdir of the port's trainer: serve its newest "
                                       "checkpoint.")
    p.add_argument("--attention", choices=("fused", "dense", "pallas"), default="fused",
                   help="Attention path; 'pallas' is the JAX name of 'fused'.")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321, help="Bind port (0 = ephemeral).")
    p.add_argument("--max_sessions", type=int, default=8,
                   help="Concurrent session slots = the largest device batch; "
                        "batches ride power-of-two buckets up to it.")
    p.add_argument("--max_batch", type=int, default=0,
                   help="Largest batch the batcher forms (0 = max_sessions; clamped to it).")
    p.add_argument("--max_delay_ms", type=float, default=10.0,
                   help="[cycle] the longest a request waits for batchmates; [continuous] the "
                        "cap on coalescing a re-forming burst (a lone client never waits).")
    p.add_argument("--max_queue", type=int, default=64,
                   help="Bounded admission queue; beyond it /act answers 503 busy.")
    p.add_argument("--scheduler", choices=("continuous", "cycle"), default="continuous",
                   help="'continuous' rolls requests into the next step (--pipeline_depth in "
                        "flight); 'cycle' waits for a full batch or the --max_delay_ms deadline.")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="[continuous] batches in flight: 2 prepares batch N+1 while N runs.")
    p.add_argument("--request_timeout_s", type=float, default=60.0,
                   help="Server-side budget of one request.")
    p.add_argument("--verbose", action="store_true", help="Log a line per request to stderr.")
    p.add_argument("--embedder", default="hash", help="Instruction embedder: hash | ngram.")
    p.add_argument("--allow_embedder_mismatch", action="store_true",
                   help="Serve a --workdir checkpoint even when its data_manifest.json records "
                        "another instruction embedder than --embedder.")
    p.add_argument("--buckets", default="auto",
                   help="Batch-size buckets, comma-separated (e.g. '1,2,4,8'); 'auto' = powers "
                        "of two up to max_sessions. Every bucket is warmed at start.")
    p.add_argument("--inference_dtype", choices=("f32", "bf16", "int8"), default="f32",
                   help="f32: the config's compute dtype; bf16: bf16 weights and compute; int8: "
                        "per-output-channel int8 weights of the quant plan, dequantized at use.")
    p.add_argument("--cached_inference", action="store_true",
                   help="Keep per-session K/V caches: a step attends the new frame against "
                        "cached keys (exact while a window fills; rebuilt on /reload).")
    p.add_argument("--replica_id", type=int, default=0,
                   help="This replica's id in a fleet (in /healthz and /metrics).")
    p.add_argument("--watch_checkpoints_s", type=float, default=0.0,
                   help="Poll --workdir's checkpoints this often and hot-swap newer steps "
                        "(0 = off).")
    p.add_argument("--session_snapshot_dir", default="",
                   help="Write an on-disk ring of session snapshots here; an /act for an "
                        "unknown session restores its snapshot (off when empty).")
    p.add_argument("--snapshot_max_age_s", type=float, default=600.0,
                   help="A ring snapshot older than this starts a fresh window instead.")
    p.add_argument("--session_snapshot_every", type=int, default=1,
                   help="Write a session's ring snapshot every N served steps.")
    p.add_argument("--slow_threshold_ms", type=float, default=0.0,
                   help="Keep requests at least this slow in the exemplar ring "
                        "(GET /slow_requests); 0 keeps the most recent window of all.")
    p.add_argument("--exemplar_path", default="",
                   help="Dump the slow-request exemplar ring here (JSONL) on drain.")
    p.add_argument("--capture_dir", default="",
                   help="Data flywheel: capture completed sessions as episode .npz files into "
                        "this directory (flywheel/capture.py). Off when empty: serving records "
                        "nothing unless an operator opts in.")
    p.add_argument("--capture_max_episodes", type=int, default=512,
                   help="Capture disk ring: keep at most this many episode files (oldest "
                        "pruned).")
    p.add_argument("--capture_max_steps", type=int, default=512,
                   help="Capture per-session step bound; steps beyond it are dropped.")
    return p.parse_args(argv)


def parse_buckets(spec: str, max_sessions: int):
    from rt1_tpu_torch.serve.engine import pow2_buckets

    if spec.strip() == "auto":
        return pow2_buckets(max_sessions)
    return [int(b) for b in spec.split(",") if b.strip()] or None


def start_checkpoint_watcher(app, workdir: str, interval_s: float, served_step) -> threading.Thread:
    """Poll `<workdir>/checkpoints` and hot-swap each newer step
    (`app.reload`), printing a `reloaded` or `reload_failed` JSON line; the
    old weights keep serving on a failure. `served_step` is the step the
    server restored at start, so a checkpoint saved meanwhile is not
    skipped. A daemon thread."""
    from rt1_tpu_torch.trainer.checkpoints import latest_step

    directory = os.path.join(os.path.abspath(workdir), "checkpoints")

    def watch():
        served = served_step if served_step is not None and served_step >= 0 else None
        while True:
            time.sleep(interval_s)
            try:
                newest = latest_step(directory)
                if newest is not None and (served is None or newest > served):
                    result = app.reload(newest)
                    served = result["checkpoint_step"]
                    print(json.dumps({"status": "reloaded", **result}), flush=True)
            except Exception as exc:  # noqa: BLE001 - keep watching
                print(json.dumps({"status": "reload_failed", "error": str(exc)}), flush=True)

    thread = threading.Thread(target=watch, name="rt1-serve-ckpt-watcher", daemon=True)
    thread.start()
    return thread


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.eval.embedding import get_embedder
    from rt1_tpu_torch.eval.restore import build_serve_engine, load_standby_variables
    from rt1_tpu_torch.resilience import faults
    from rt1_tpu_torch.serve.server import ServeApp, install_signal_handlers, make_server

    # Arm the replica's chaos sites from RT1_FAULTS (the fleet exports its
    # plan before spawning).
    faults.install_from("")
    config = get_config(args.config)
    if args.workdir and not args.allow_embedder_mismatch:
        # Same guard as the eval CLI: a checkpoint served with another
        # instruction embedder than it was trained on decodes foreign
        # embeddings and answers 200 OK with wrong actions.
        from rt1_tpu_torch.data.episodes import check_embedder_compatibility

        check_embedder_compatibility(
            args.workdir,
            args.embedder,
            context="checkpoint data_manifest; pass --allow_embedder_mismatch to override",
            manifest_name="data_manifest.json",
        )
    embedder = get_embedder(args.embedder)
    engine, step = build_serve_engine(
        config,
        weights=args.weights,
        workdir=args.workdir,
        device=args.device,
        attention_impl=args.attention,
        inference_dtype=args.inference_dtype,
        cached_inference=args.cached_inference,
        max_sessions=args.max_sessions,
        buckets=parse_buckets(args.buckets, args.max_sessions),
        embedder=embedder,
    )

    def reload_fn(reload_step):
        # The standby: the same source's f32 masters (random init rebuilds
        # the same seeded weights).
        return load_standby_variables(config, weights=args.weights, workdir=args.workdir,
                                      step=reload_step)

    # Flywheel capture shares the engine's embedder, so text-only clients
    # still yield episodes that carry their instruction's embedding.
    capture = None
    if args.capture_dir:
        from rt1_tpu_torch.flywheel import EpisodeCaptureSink

        capture = EpisodeCaptureSink(
            args.capture_dir,
            max_episodes=args.capture_max_episodes,
            max_steps=args.capture_max_steps,
            embed_fn=embedder,
        )

    app = ServeApp(
        engine,
        image_shape=(config.data.height, config.data.width, 3),
        max_batch=args.max_batch or None,
        max_delay_s=args.max_delay_ms / 1e3,
        max_queue=args.max_queue,
        scheduler=args.scheduler,
        pipeline_depth=args.pipeline_depth,
        request_timeout_s=args.request_timeout_s,
        replica_id=args.replica_id,
        reload_fn=reload_fn,
        checkpoint_step=step if step is not None else -1,
        session_snapshot_dir=args.session_snapshot_dir or None,
        snapshot_max_age_s=args.snapshot_max_age_s,
        snapshot_every=args.session_snapshot_every,
        slow_threshold_ms=args.slow_threshold_ms,
        exemplar_path=args.exemplar_path or None,
        capture=capture,
    )
    app.start(warmup=True)
    if args.watch_checkpoints_s > 0 and args.workdir:
        start_checkpoint_watcher(app, args.workdir, args.watch_checkpoints_s, served_step=step)
    httpd = make_server(app, host=args.host, port=args.port, quiet=not args.verbose)
    install_signal_handlers(app, httpd)
    print(
        json.dumps(
            {
                "status": "serving",
                "host": httpd.server_address[0],
                "port": httpd.server_address[1],
                "checkpoint_step": step,
                "max_sessions": engine.max_sessions,
                "compile_count": engine.compile_count,
                "buckets": [int(b) for b in engine.buckets],
                "scheduler": args.scheduler,
                "device": str(engine.device),
                "dtype": engine.dtype,
                "attention": engine.policy.transformer.layer_0.attn.attention_impl,
                "replica_id": args.replica_id,
                "inference_dtype": engine.inference_dtype,
                "cached_inference": engine.cached_inference,
                "param_bytes_device": engine.serving_param_bytes,
            }
        ),
        flush=True,
    )
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if not app.draining:
            app.drain()
    print(json.dumps({"status": "drained", **app.metrics_snapshot()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
