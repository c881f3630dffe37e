"""Serving entry point: `python -m rt1_tpu_torch.serve`.

Run (flagship config, random weights, on the card):

  python -m rt1_tpu_torch.serve --config language_table --random_init --port 8321

Run (the JAX package's weights, saved as an .npz of `/`-joined flax paths):

  python -m rt1_tpu_torch.serve --config language_table --weights params.npz

Run (what `python -m rt1_tpu_torch.train` wrote: its newest checkpoint):

  python -m rt1_tpu_torch.serve --config language_table --workdir /tmp/rt1_torch

Run (smoke config on the CPU):

  python -m rt1_tpu_torch.serve --config tiny --random_init --port 0 --device cpu

Prints one JSON ready-line (`{"status": "serving", "port": ...}`) once every
bucket is warmed and the socket is bound, then serves until SIGTERM/SIGINT,
which drains accepted requests, prints a final `{"status": "drained", ...}`
line and exits 0. `--attention fused` (the default) runs the hand-written
attention kernel on the card; `--attention dense` the plain path.
"""

from __future__ import annotations

import argparse
import json
import sys


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
    p.add_argument("--scheduler", choices=("continuous", "cycle"), default="continuous",
                   help="'continuous' rolls requests into the next step (two in flight); "
                        "'cycle' waits for a full batch or a 10 ms deadline.")
    p.add_argument("--embedder", default="hash", help="Instruction embedder: hash | ngram.")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.eval.embedding import get_embedder
    from rt1_tpu_torch.eval.restore import build_serve_engine
    from rt1_tpu_torch.serve.engine import pow2_buckets
    from rt1_tpu_torch.serve.server import ServeApp, install_signal_handlers, make_server

    config = get_config(args.config)
    engine, step = build_serve_engine(
        config,
        weights=args.weights,
        workdir=args.workdir,
        device=args.device,
        attention_impl=args.attention,
        max_sessions=args.max_sessions,
        buckets=pow2_buckets(args.max_sessions),
        embedder=get_embedder(args.embedder),
    )
    app = ServeApp(
        engine,
        image_shape=(config.data.height, config.data.width, 3),
        scheduler=args.scheduler,
    )
    app.start(warmup=True)
    httpd = make_server(app, host=args.host, port=args.port)
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
