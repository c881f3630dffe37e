"""Terminal ops console: the `/dashboard` story as refreshing text.

The port's `python -m` entry for the JAX package's `scripts/obs_console.py`
(same flags and output). Two modes, same renderer
(`obs/dashboard.py::render_console`):

* **Live** — ``--url http://host:port`` points at any fleet router (or
  train metrics listener). The console runs its own local collector:
  scrape the target's ``/metrics`` into a private TSDB, evaluate the
  default alert ruleset, and redraw ALERTS / COLLECTOR / HISTORY every
  ``--interval_s``. It needs nothing armed server-side — the history
  lives in this process.
* **Post-mortem** — ``--snapshot path/tsdb_snapshot.jsonl`` restores a
  fleet's shutdown snapshot (written by ``--collector`` fleets or
  `python -m rt1_tpu_torch.obs.collector_main`) and renders the
  sparklines once.

``--once`` renders a single frame and exits (tests, piping to a file).
Stdlib-only.
"""

import argparse
import sys
import time

from rt1_tpu_torch.obs.alerts import AlertManager, default_ruleset
from rt1_tpu_torch.obs.collector import Collector, Target
from rt1_tpu_torch.obs.dashboard import render_console
from rt1_tpu_torch.obs.tsdb import TSDB


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.obs.console", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "--url", default="",
        help="Live mode: scrape this base URL's /metrics.")
    parser.add_argument(
        "--snapshot", default="",
        help="Post-mortem mode: render a tsdb_snapshot.jsonl once.")
    parser.add_argument("--interval_s", type=float, default=2.0)
    parser.add_argument("--window_s", type=float, default=900.0)
    parser.add_argument("--max_series", type=int, default=40)
    parser.add_argument(
        "--once", action="store_true",
        help="One frame, no clear, exit 0 (tests / piping).")
    args = parser.parse_args(argv)

    if bool(args.url) == bool(args.snapshot):
        parser.error("pass exactly one of --url / --snapshot")

    tsdb = TSDB()
    if args.snapshot:
        restored = tsdb.restore(args.snapshot)
        print(f"restored {restored} points from {args.snapshot}\n")
        sys.stdout.write(
            render_console(
                tsdb,
                window_s=args.window_s,
                max_series=args.max_series,
            )
        )
        return 0

    manager = AlertManager(tsdb, default_ruleset())
    collector = Collector(
        tsdb,
        [Target("target", args.url.rstrip("/") + "/metrics")],
        interval_s=args.interval_s,
        alert_manager=manager,
    )
    try:
        while True:
            collector.scrape_once()
            frame = render_console(
                tsdb,
                alert_manager=manager,
                collector=collector,
                window_s=args.window_s,
                max_series=args.max_series,
            )
            if args.once:
                sys.stdout.write(frame)
                return 0
            # ANSI clear + home, like watch(1) — the console IS the UI.
            sys.stdout.write("\x1b[2J\x1b[H" + frame)
            sys.stdout.flush()
            time.sleep(args.interval_s)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
