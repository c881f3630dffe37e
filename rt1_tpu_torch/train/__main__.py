"""Training entry point: `python -m rt1_tpu_torch.train`.

Run (the flagship on the card, synthetic batches):

  python -m rt1_tpu_torch.train --config language_table --workdir /tmp/rt1_torch

Run (the smoke config on the CPU, 4 steps, checkpoints at 2 and 4):

  python -m rt1_tpu_torch.train --config tiny --workdir /tmp/rt1_tiny --device cpu

Run (the flagship on the card from Language-Table episode files, through
the packed cache; pack each split once first):

  python -m rt1_tpu_torch.data.pack_dataset --data_dir /data/lt --split train --split val
  python -m rt1_tpu_torch.train --config language_table --workdir /tmp/rt1_torch \\
      --set data.data_dir=/data/lt --set data.packed_cache=True

Without `data.packed_cache` (or with a stale pack) the episodes go through
the windowed loader: `data.loader=tf` (the default: the torch loader in
the order of tf.data's `shuffle(min(windows, data.shuffle_buffer))`) or
`torch` (a DataLoader of `data.num_workers` processes, a permutation an
epoch) or `numpy` (the loop's own thread). With `data.data_dir` empty the
loop trains on synthetic batches.

`--sweep_trial N` applies trial N of the config's hyperparameter sweep
(`configs.sweep`: the flagship's learning rates 1e-3, 5e-4, 1e-4) before
the `--set` overrides and logs it as a `sweep_trial` line.

Other models: `--set model.ffn_impl=moe` (the Switch-routed expert FFN;
its load-balancing loss joins the train loss, `moe_aux_loss` in the
metrics), `--set model.remat=true` (recompute each decoder layer and
MBConv block in the backward pass), `--set model.family=lava` or `--config
lava_tiny` (the LAVA family on its MSE loss, in float32;
`--set model.lava.lang_encoder=clip --set data.clip_tokens=true` feeds its
CLIP text tower from the episodes' instruction text).

Override any config field with `--set key=value` (repeatable), e.g.
`--set num_steps=6 --set model.dropout_rate=0`; `--set
model.attention_impl=fused` runs the eval steps' attention through the
fused kernel (train steps always run dense). A second run in the same
workdir resumes from the newest checkpoint (the data stream restarts).
Prints one JSON line at the start (`restored_step` names the checkpoint
it resumed from, `data_loader` the source of the batches, `metrics_url`
the scrape listener's), one per log and eval step, and one at the end;
serve the result with
`python -m rt1_tpu_torch.serve --config <name> --workdir <dir>`.

Several processes, one device each (`config.parallel`; README "Multi-process
training"): on the CPU over gloo,

  python -m torch.distributed.run --standalone --nproc_per_node 2 \
      -m rt1_tpu_torch.train --config tiny --workdir /tmp/rt1_dp --device cpu \
      --set parallel.distributed.enabled=true --set parallel.fsdp=2

and on the card over NCCL the same without `--device cpu` (one rank a GPU:
`--nproc_per_node` at most the host's GPUs). `parallel.dp`, `fsdp`, `sp`
(with `model.attention_impl=ring`), `tp` (tensor parallelism), `pp` (the
GPipe pipeline, `model.pipeline_microbatches` a step, dense attention),
`auto` and `strict` act. Rank 0 logs and writes the
workdir's files; every rank writes its part of each checkpoint, which any
plan, a world of one included, restores.

Resilience and observability run as the config sets them (the flagship's
`resilience.*` and `obs.*` turn on the guard, I/O retry, preemption save,
the health pack, the goodput ledger with its MFU gauge and the flight
recorder). `--set obs.prometheus_port=0` serves `rt1_train_*` gauges on an
ephemeral port (the start line's `metrics_url`); `--set
resilience.faults=nan_batch@2,ckpt_save@1,sigterm@9` (or `RT1_FAULTS=...`)
injects faults on a schedule. A SIGTERM or SIGINT saves a checkpoint at
the current step and exits 0 (the end line says `"preempted": true`); a
second one kills the process. `<workdir>/goodput_summary.json` is written
at every exit, `<workdir>/flight_record.jsonl` on a crash, SIGTERM or
preemption.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.train", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True,
                   help="language_table | tiny | lava_tiny (or the path of the JAX config file "
                        "of that name)")
    p.add_argument("--workdir", required=True, help="Checkpoints and metrics.jsonl go here.")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    p.add_argument("--sweep_trial", type=int, default=-1,
                   help="Apply trial N of the config's sweep() before --set (-1: none).")
    p.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                   help="Override a config field (dotted key), repeatable.")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch.configs import apply_override, get_config
    from rt1_tpu_torch.train.train import apply_sweep_trial, train_and_evaluate

    config = get_config(args.config)
    if args.sweep_trial >= 0:
        overrides = apply_sweep_trial(config, args.config, args.sweep_trial)
        print(json.dumps({"status": "sweep_trial", "trial": args.sweep_trial,
                          "overrides": overrides}), flush=True)
    for assignment in args.overrides:
        apply_override(config, assignment)
    from rt1_tpu_torch.parallel import distributed

    try:
        train_and_evaluate(config, args.workdir, device=args.device)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
