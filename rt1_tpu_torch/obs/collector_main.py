"""Standalone metrics collector: scrape targets into a TSDB, alert, snapshot.

The port's `python -m` entry for the JAX package's `scripts/obs_collector.py`
(same flags and output). The same plane `rt1_tpu_torch.serve.fleet
--collector` runs in-process, as its
own process — point it at any set of exposition/JSON endpoints (a train
process's Prometheus listener, a router's fleet fan-out, a
``/deploy/status`` JSON) and it polls them on one cadence, evaluates the
default alert ruleset after every cycle, streams alert transitions as
JSONL on stdout, and writes an atomic ``tsdb_snapshot.jsonl`` on exit
(and optionally every ``--snapshot_every_s``) for the post-mortem.

    python -m rt1_tpu_torch.obs.collector_main \
        --target fleet=http://127.0.0.1:8400/metrics \
        --target train=http://127.0.0.1:8300/metrics \
        --json_target deploy=http://127.0.0.1:8400/deploy/status \
        --snapshot /tmp/obs/tsdb_snapshot.jsonl --interval_s 5

Stdlib-only, like the rest of the metrics plane — this runs on a host
with neither torch nor a card.
"""

import argparse
import json
import signal
import sys
import threading
import time

from rt1_tpu_torch.obs.alerts import AlertManager, default_ruleset
from rt1_tpu_torch.obs.collector import Collector, Target
from rt1_tpu_torch.obs.tsdb import TSDB


def _parse_target(spec: str, kind: str) -> Target:
    """``name=url`` (metrics) or ``name=url[:prefix]`` (json; the prefix
    defaults to ``rt1_<name>``)."""
    name, sep, url = spec.partition("=")
    if not sep or not name or not url:
        raise argparse.ArgumentTypeError(
            f"target spec {spec!r} is not name=url"
        )
    if kind == "json":
        return Target(name, url, kind="json", prefix=f"rt1_{name}")
    return Target(name, url)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.obs.collector_main", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "--target", action="append", default=[],
        help="Exposition target as name=url (repeatable).")
    parser.add_argument(
        "--json_target", action="append", default=[],
        help="JSON status target as name=url (repeatable); numeric "
             "leaves land under rt1_<name>_*.")
    parser.add_argument("--interval_s", type=float, default=5.0)
    parser.add_argument(
        "--snapshot", default="",
        help="tsdb_snapshot.jsonl path, written atomically on exit.")
    parser.add_argument(
        "--snapshot_every_s", type=float, default=0.0,
        help="Also rewrite the snapshot this often (0 = exit only), so "
             "a SIGKILLed collector still leaves recent history.")
    parser.add_argument(
        "--max_cycles", type=int, default=0,
        help="Stop after this many scrape cycles (0 = run until "
             "SIGINT/SIGTERM). Tests use 1.")
    parser.add_argument(
        "--no_alerts", action="store_true",
        help="Scrape/store only, skip the default alert ruleset.")
    args = parser.parse_args(argv)

    targets = [_parse_target(s, "metrics") for s in args.target]
    targets += [_parse_target(s, "json") for s in args.json_target]
    if not targets:
        parser.error("need at least one --target / --json_target")

    tsdb = TSDB()
    manager = None
    if not args.no_alerts:
        # Alert transitions stream to stdout as they happen — the JSONL
        # a pager webhook or `tail -f` consumes.
        emit = lambda ev: print(json.dumps(ev), flush=True)  # noqa: E731
        manager = AlertManager(
            tsdb, default_ruleset(), on_fire=emit, on_resolve=emit
        )
    collector = Collector(
        tsdb, targets, interval_s=args.interval_s, alert_manager=manager
    )

    stop = threading.Event()

    def _shutdown(signum, frame):  # noqa: ARG001 - signal signature
        stop.set()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    cycles = 0
    last_snap = time.monotonic()
    while not stop.is_set():
        collector.scrape_once()
        cycles += 1
        if args.max_cycles and cycles >= args.max_cycles:
            break
        if (
            args.snapshot
            and args.snapshot_every_s > 0
            and time.monotonic() - last_snap >= args.snapshot_every_s
        ):
            tsdb.write_snapshot(args.snapshot)
            last_snap = time.monotonic()
        stop.wait(args.interval_s)

    if args.snapshot:
        tsdb.write_snapshot(args.snapshot)
    print(
        json.dumps(
            {
                "status": "stopped",
                "collector": collector.stats(),
                "tsdb": tsdb.stats(),
                "alerts": manager.counters() if manager else None,
                "snapshot": args.snapshot or None,
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
