"""One train step under each parallelism mode on 8 ranks, on `rt1_tpu_torch`
(the port's counterpart of `examples/parallelism_example.py`).

JAX runs the five modes on an 8-device virtual mesh and lets GSPMD insert
the collectives. Here 8 processes form one gloo world, started once for
all five modes through a `file://` rendezvous. Each mode lays its own rank
grid (`parallel.mesh.RankGrid`) over those ranks, cuts the policy to the
rank's part (`parallel.partition_policy`) and takes ONE Adam step (lr 1e-3)
of a tiny RT-1 through the port's trainer (`trainer.train.TrainStepFns`)
on the same 8-row batch:

  dp  data 8
  tp  data 2 x model 4   the FFN, the token embedding's and the head's
                         columns split; 2 heads on 4 ranks stay whole
  sp  data 4 x seq 2     ring attention over the 10-token window
  pp  data 2 x stage 4   GPipe over the 4 layers, 2 microbatches
  ep  data 2 x model 4   Switch MoE FFN, one of the 4 experts a rank

Placement: NCCL takes one device a rank, so the ranks share the card over
gloo. dp, tp and ep put every rank on the card (gloo's all-reduce and
all-gather take CUDA tensors). sp and pp put theirs on the host CPU under
either `--device`, because the ring and the pipeline send point to point
and gloo sends no CUDA tensor point to point. Each line says where its
mode ran, how often its ranks launched the fused-attention kernel (never:
training takes the dense attention, as JAX's does) and how long its step
took on the slowest rank. That is a first step, warm-up included: under
pp each stage's first backward also imports a part of torch, one stage
after another.

The weights (flax's initializer families from seed 0), the batch and the
step's crop (`TrainStepFns(crop_on_host=True)`; the card's generator
draws other numbers than the host's from one seed) are drawn on the host,
and the step computes in float32 with TF32 off, so the card's lines agree
with `--device cpu`'s, and with each other, up to rounding, as JAX's
example gives the same numbers on every platform.

Run:
  python examples/torch/parallelism_example.py               # the card
  python examples/torch/parallelism_example.py --device cpu
"""

import argparse
import datetime
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import traceback

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

import torch

from rt1_tpu_torch import resolve_device
from rt1_tpu_torch.convert import init_weights
from rt1_tpu_torch.models.rt1 import RT1Policy
from rt1_tpu_torch.models.tiny_tokenizer import TinyImageTokenizer
from rt1_tpu_torch.parallel import MeshConfig, RankGrid, ShardingPlan, partition_policy
from rt1_tpu_torch.parallel import mesh as mesh_lib
from rt1_tpu_torch.parallel.flash_attention import fused_attention
from rt1_tpu_torch.specs import DiscreteSpec, language_table_action_space
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import create_train_state
from rt1_tpu_torch.trainer.train import TrainStepFns

T, EMB = 2, 16
WORLD = 8
TIMEOUT_S = 600

MODES = [
    # (label, mesh config, model kwargs)
    ("dp  (data parallel, DDP equivalent)", MeshConfig(), {}),
    ("tp  (tensor parallel heads/FFN)", MeshConfig(data=2, model=4), {}),
    ("sp  (ring attention over seq)", MeshConfig(seq=2), {}),
    ("pp  (GPipe over decoder layers)", MeshConfig(data=2, stage=4),
     dict(pipeline_microbatches=2)),
    ("ep  (Switch MoE expert FFN)", MeshConfig(data=2, model=4),
     dict(ffn_impl="moe", num_experts=4)),
]


def tiny(**kw):
    cfg = dict(
        action_space=language_table_action_space(),
        vocab_size=32,
        token_embedding_size=EMB,
        num_layers=4,
        layer_size=8,
        num_heads=2,
        feed_forward_size=16,
        dropout_rate=0.0,
        time_sequence_length=T,
        num_image_tokens=2,
        image_tokenizer=TinyImageTokenizer(num_tokens=2, emb=EMB, context_dim=8),
    )
    cfg.update(kw)
    return RT1Policy(**cfg)


def batch(generator, b=8):
    obs = {
        "image": torch.rand((b, T, 16, 16, 3), generator=generator),
        "natural_language_embedding": torch.randn((b, T, 8), generator=generator),
    }
    actions = {}
    for key, spec in language_table_action_space().items():
        if isinstance(spec, DiscreteSpec):
            actions[key] = torch.randint(0, spec.n, (b, T), generator=generator,
                                         dtype=torch.int32)
        else:
            lo = torch.from_numpy(spec.low_array().copy())
            hi = torch.from_numpy(spec.high_array().copy())
            u = torch.rand((b, T) + spec.shape, generator=generator)
            actions[key] = lo + u * (hi - lo)
    return obs, actions


def mode_device(grid, device):
    """Where a mode's ranks run: the host when the mode sends point to
    point (seq or stage above 1), else `device` (the module docstring)."""
    if grid.size("seq") > 1 or grid.size("stage") > 1:
        return torch.device("cpu")
    return torch.device("cuda", 0) if torch.device(device).type == "cuda" else torch.device("cpu")


def mode_step(mesh_cfg, model_kw, device, weights, rows, tiny_kw=None):
    """One Adam step of the mode on this rank: its global loss and
    gradient norm, its wall seconds (the first step: warm-up included) and
    the fused-attention kernel's launches in it (none: training takes the
    dense attention, as in JAX). `tiny_kw` goes to every mode's
    `tiny()`."""
    grid = RankGrid(mesh_cfg)
    where = mode_device(grid, device)
    kw = dict(model_kw, **(tiny_kw or {}))
    microbatches = kw.pop("pipeline_microbatches", 4)
    if grid.size("seq") > 1:
        kw.update(attention_impl="ring")
    policy = tiny(**kw)
    init_weights(policy, torch.Generator().manual_seed(0))
    if weights is not None:
        policy.load_state_dict(weights[kw.get("ffn_impl", "dense")])
    policy.to(where)
    mesh_lib.set_current(grid)   # the decoder's ring reads its `seq` group
    try:
        partition = partition_policy(policy, grid, ShardingPlan(mesh=grid.mesh), microbatches)
        tx = Adam(learning_rate=1e-3)
        state = create_train_state(policy, tx, partition)
        fns = TrainStepFns(tx, seed=1, grid=grid, crop_on_host=True)
        n = len(rows[1]["action"]) // grid.batch_ways
        block = slice(grid.batch_index * n, (grid.batch_index + 1) * n)
        local = tuple({k: v[block].to(where) for k, v in tree.items()} for tree in rows)
        launched, t0 = fused_attention.launches, time.perf_counter()
        metrics = fns.train_step(state, local, 0)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])  # waits
        return {"mesh": dict(grid.mesh.shape), "device": str(where), "loss": loss,
                "grad_norm": grad_norm, "step_s": time.perf_counter() - t0,
                "launches": fused_attention.launches - launched}
    finally:
        mesh_lib.set_current(None)


def _rank(rank, world, workdir, device):
    """A spawned rank: the gloo rendezvous, then every mode in turn."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
        dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        records = [dict(mode_step(mesh_cfg, kw, device, payload["weights"], payload["batch"],
                                  payload["tiny_kw"]), label=label)
                   for label, mesh_cfg, kw in MODES]
        torch.save(records, os.path.join(workdir, f"result_{rank}.pt"))
    except BaseException:  # noqa: BLE001 - reported to the launching process
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(device="cuda", weights=None, rows=None, tiny_kw=None):
    """Every mode's step on WORLD ranks: rank 0's records in MODES' order,
    each with every rank's devices and losses, the slowest rank's step
    seconds and the ranks' kernel launches in all. `weights` maps "dense"
    and "moe" to a state_dict of `tiny()` and of the MoE `tiny()` (default:
    the seed-0 init); `rows` is the (obs, actions) batch (default: `batch`
    from seed 0); `tiny_kw` goes to every mode's `tiny()` (the tests turn
    the crop off, which no seed makes JAX's)."""
    device = str(resolve_device(device))
    if rows is None:
        rows = batch(torch.Generator().manual_seed(0))
    workdir = tempfile.mkdtemp(prefix="rt1_parallelism_example_")
    try:
        torch.save({"weights": weights, "batch": rows, "tiny_kw": tiny_kw},
                   os.path.join(workdir, "payload.pt"))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, WORLD, workdir, device))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(workdir, f"error_{r}.txt")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("\n".join(errors))
        results = [torch.load(os.path.join(workdir, f"result_{r}.pt"), weights_only=False)
                   for r in range(WORLD)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return [dict(records[0], devices=sorted({r["device"] for r in records}),
                 losses=[r["loss"] for r in records],
                 step_s=max(r["step_s"] for r in records),
                 launches=sum(r["launches"] for r in records))
            for records in zip(*results)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    for record in run(args.device):
        print(
            f"{record['label']:40s} mesh={record['mesh']} "
            f"loss={record['loss']:.5f} "
            f"grad_norm={record['grad_norm']:.4f} "
            f"device={','.join(record['devices'])} "
            f"attention_launches={record['launches']} "
            f"step_ms={1e3 * record['step_s']:.1f}"
        )


if __name__ == "__main__":
    main()
