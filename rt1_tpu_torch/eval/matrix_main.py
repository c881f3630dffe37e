"""Closed-loop task × checkpoint eval matrix CLI (`eval/matrix.py`):
`python -m rt1_tpu_torch.eval.matrix_main`.

The port's entry for the JAX package's `scripts/eval_matrix.py`, with the
same flags and record. Runs the closed-loop protocol (`eval/evaluate.py`)
over every requested reward family × checkpoint cell, exposes live
``rt1_eval_*`` Prometheus gauges while the sweep runs, and writes one
BENCH-style JSON (``BENCH_eval_matrix.json``): the offline promotion-gate
signal for the deploy loop. Policies run on `--device` (the card unless
`--device cpu`) with the fused attention kernel.

  # All retained checkpoints x all nine reward families:
  python -m rt1_tpu_torch.eval.matrix_main --config tiny --workdir /tmp/rt1 \\
      --episodes 3 --device cpu

  # Two newest checkpoints, two families, live gauges on :9109, and
  # oracle-generated corpora appended to the training pack first:
  python -m rt1_tpu_torch.eval.matrix_main --config language_table \\
      --workdir /tmp/rt1 --checkpoints latest:2 --tasks block2block \\
      --tasks block1_to_corner --prometheus_port 9109 \\
      --fill_pack_dir /data/lt/train_packed --fill_episodes 4

The last line of stdout is the record.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

_log = logging.getLogger("rt1_tpu_torch.eval.matrix")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.eval.matrix_main",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True,
                   help="language_table | tiny | lava_tiny (or the path of the JAX config file "
                        "of that name)")
    p.add_argument("--workdir", default="/tmp/rt1_tpu", help="Checkpoint directory.")
    p.add_argument("--checkpoints", default="all",
                   help="Which checkpoint steps to evaluate: 'all', 'latest:N', or a "
                        "comma-separated step list.")
    p.add_argument("--tasks", action="append", default=[],
                   help="Reward families to evaluate (repeatable); default: every canonical "
                        "family.")
    p.add_argument("--episodes", type=int, default=3, help="Episodes per (task, ckpt) cell.")
    p.add_argument("--max_steps", type=int, default=80, help="Max steps per episode.")
    p.add_argument("--block_mode", default="BLOCK_8", help="Block variant.")
    p.add_argument("--seed", type=int, default=0, help="Env seed.")
    p.add_argument("--embedder", default="hash", help="Instruction embedder spec.")
    p.add_argument("--backend", default="kinematic",
                   help="Physics backend: kinematic | kinematic_arm | auto.")
    p.add_argument("--baselines", default="",
                   help="Extra policy columns next to the checkpoints: comma subset of "
                        "'oracle,random' (the protocol ceiling and chance floor).")
    p.add_argument("--prometheus_port", type=int, default=-1,
                   help=">= 0: serve live rt1_eval_* gauges on this port during the sweep "
                        "(0 = ephemeral, logged at startup); < 0: off.")
    p.add_argument("--out", default="",
                   help="Extra path for the BENCH record (a copy always lands at "
                        "<workdir>/BENCH_eval_matrix.json).")
    p.add_argument("--fill_pack_dir", default="",
                   help="Existing packed-cache dir to append oracle-generated per-task corpora "
                        "to (the append_shard path) before the sweep.")
    p.add_argument("--fill_tasks", action="append", default=[],
                   help="Families to oracle-fill (default: the sweep's --tasks).")
    p.add_argument("--fill_episodes", type=int, default=4,
                   help="Oracle episodes to collect per filled task.")
    p.add_argument("--fill_episodes_dir", default="",
                   help="Where the oracle-generated episode files land (default "
                        "<workdir>/eval_matrix_fill).")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stderr)

    from rt1_tpu_torch import resolve_device
    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.eval import matrix as matrix_lib

    device = resolve_device(args.device)
    config = get_config(args.config)
    t0 = time.time()
    tasks = tuple(args.tasks) or matrix_lib.default_task_names()

    fill_summary = None
    if args.fill_pack_dir:
        fill_tasks = tuple(args.fill_tasks) or tasks
        _log.info("eval_matrix: oracle-filling %s with %d episodes/task for %s",
                  args.fill_pack_dir, args.fill_episodes, fill_tasks)
        fill_summary = matrix_lib.fill_pack(
            args.fill_pack_dir,
            args.fill_episodes_dir or os.path.join(args.workdir, "eval_matrix_fill"),
            fill_tasks,
            args.fill_episodes,
            block_mode=args.block_mode,
            seed=args.seed,
            max_steps=args.max_steps,
            embedder=args.embedder,
        )
        _log.info("eval_matrix: fill summary %s", fill_summary)

    steps = matrix_lib.checkpoint_steps(args.workdir, args.checkpoints)
    # Lazy per-checkpoint restore: run_matrix calls each factory when its
    # column starts, so a long `--checkpoints all` list keeps ONE restored
    # parameter set resident instead of all of them.
    policies = [
        (str(step),
         lambda s=step: matrix_lib.policy_for_checkpoint(config, args.workdir, s,
                                                         device=device)[0])
        for step in steps
    ]
    if args.baselines:
        from rt1_tpu_torch.eval.evaluate import OracleEvalPolicy, RandomEvalPolicy

        for name in args.baselines.split(","):
            name = name.strip()
            if name == "oracle":
                policies.append((name, OracleEvalPolicy(seed=args.seed)))
            elif name == "random":
                policies.append((name, RandomEvalPolicy(seed=args.seed)))
            elif name:
                raise ValueError(f"unknown baseline {name!r}")
    if not policies:
        raise SystemExit(
            f"eval_matrix: no checkpoints under {args.workdir}/checkpoints "
            f"(spec {args.checkpoints!r}) and no --baselines"
        )

    env_kwargs = dict(
        target_height=config.data.height,
        target_width=config.data.width,
        random_crop_factor=config.data.crop_factor,
        sequence_length=config.model.time_sequence_length,
        backend=args.backend,
    )

    state = matrix_lib.EvalMatrixState()
    server = None
    if args.prometheus_port >= 0:
        from rt1_tpu_torch.obs import MetricsServer

        server = MetricsServer(state.render_prometheus, port=args.prometheus_port)
        _log.info("eval_matrix: live gauges at %s", server.url)

    def progress(task, label, cell):
        _log.info("eval_matrix: cell (%s, ckpt %s): %d/%d success, mean len %.1f",
                  task, label, cell["successes"], cell["episodes"],
                  cell["mean_episode_length"])

    try:
        matrix_lib.run_matrix(
            policies,
            tasks,
            episodes_per_cell=args.episodes,
            max_episode_steps=args.max_steps,
            block_mode=args.block_mode,
            seed=args.seed,
            embedder=args.embedder,
            env_kwargs=env_kwargs,
            state=state,
            progress=progress,
        )
    finally:
        if server is not None:
            server.close()

    extra = {}
    if fill_summary is not None:
        extra["oracle_fill"] = fill_summary
    record = matrix_lib.matrix_record(
        state,
        episodes_per_cell=args.episodes,
        max_episode_steps=args.max_steps,
        seed=args.seed,
        embedder=args.embedder,
        backend=args.backend,
        block_mode=args.block_mode,
        wall_seconds=time.time() - t0,
        workdir=os.path.abspath(args.workdir),
        extra=extra,
    )
    written = matrix_lib.write_record(
        record, os.path.join(args.workdir, matrix_lib.BENCH_BASENAME), args.out)
    _log.info("eval_matrix: record written to %s", written)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
