"""Process groups for the port's parallel tests, on the CPU over gloo.

This module imports neither JAX nor `rt1_tpu`: a spawned child imports the
module of its target, and a worker defined in a test file (which imports
JAX for its oracles) would import JAX in every child. The test files
compute the JAX oracles in the parent.

`spawn(n, target, payload, tmp)` starts n processes (the `spawn` start
method), each of which rendezvouses through `parallel.distributed.
initialize_from_config` with a `file://` coordinator under `tmp` (never a
probed TCP port: test files run side by side), runs `target(rank, world,
payload)` (a function of this module, named), and saves its result; the
parent gets the list of results in rank order, or the first child's
traceback as an AssertionError.

The checks of a test file run inside ONE group of each size: a target
loops over a list of check specs, building a grid per spec (each grid
creates its own process groups, on every rank in the same order).
"""

from __future__ import annotations

import multiprocessing
import os
import traceback
import uuid

import numpy as np
import torch

OPT = dict(learning_rate=5e-4, milestones=(1,), gamma=0.1, steps_per_epoch=1)


def spawn(nprocs, target, payload, tmp, timeout=300):
    """Run `target` (a name in this module) on `nprocs` ranks; returns
    their results in rank order."""
    ctx = multiprocessing.get_context("spawn")
    tag = uuid.uuid4().hex[:8]
    tmp = str(tmp)
    init = os.path.join(tmp, f"init_{tag}")
    procs = [ctx.Process(target=_entry, args=(r, nprocs, init, target, payload, tmp, tag))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(tmp, f"error_{tag}_{r}.txt")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if alive:
        errors.append(f"{len(alive)} rank(s) still running after {timeout} s")
    if errors:
        raise AssertionError("\n".join(errors))
    return [torch.load(os.path.join(tmp, f"result_{tag}_{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def _entry(rank, world, init, target, payload, tmp, tag):
    torch.set_num_threads(1)
    from rt1_tpu_torch.parallel import distributed

    try:
        distributed.initialize_from_config(
            {"parallel": {"distributed": {"enabled": True, "coordinator_address": f"file://{init}",
                                          "process_id": rank, "num_processes": world}}},
            device="cpu")
        result = globals()[target](rank, world, payload)
        torch.save(result, os.path.join(tmp, f"result_{tag}_{rank}.pt"))
    except BaseException:  # noqa: BLE001 - reported to the parent
        with open(os.path.join(tmp, f"error_{tag}_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    finally:
        distributed.shutdown()


# ----------------------------------------------------------------- batches


def global_batch(seed, b, t, h, w, emb=512):
    """A numpy (obs, actions) batch of `b` rows."""
    rng = np.random.default_rng(seed)
    obs = {"image": rng.uniform(0, 1, (b, t, h, w, 3)).astype(np.float32),
           "natural_language_embedding": rng.standard_normal((b, t, emb)).astype(np.float32)}
    actions = {"terminate_episode": rng.integers(0, 2, (b, t)).astype(np.int32),
               "action": rng.uniform(-0.1, 0.1, (b, t, 2)).astype(np.float32)}
    return obs, actions


def rows(batch, block, blocks, order=None):
    """Block `block` of `blocks` of a numpy batch (after `order`), as torch."""
    obs, actions = batch
    b = next(iter(obs.values())).shape[0]
    n = b // blocks
    idx = np.arange(b) if order is None else np.asarray(order)
    pick = idx[block * n:(block + 1) * n]
    return ({k: torch.from_numpy(v[pick]) for k, v in obs.items()},
            {k: torch.from_numpy(v[pick]) for k, v in actions.items()})


# ----------------------------------------------------------------- the step


def full_flat(state, fns, flat):
    """The whole logical vector (`layout.size`) of a chunk of the masters'
    layout (every rank of the fsdp line calls it); `flat` itself without a
    shard."""
    if state.shard is None:
        return flat
    return fns._comms.gather_flat(flat.contiguous(), state.shard.size)[:state.layout.size]


def logical_state(state, fns=None):
    """The train state as host tensors in its logical layout: masters, both
    moments, the BatchNorm statistics and the counters. Under fsdp every
    rank of the fsdp line must call it (it gathers)."""
    opt = state.opt_state
    return {
        "flat": full_flat(state, fns, state.flat).detach().cpu().clone(),
        "mu": full_flat(state, fns, opt.mu).detach().cpu().clone(),
        "nu": full_flat(state, fns, opt.nu).detach().cpu().clone(),
        "buffers": state.flat_buffers.detach().cpu().clone(),
        "count": int(opt.count),
        "step": int(state.step),
        "guard_skips": int(state.guard_skips),
    }


def make_config(name, overrides):
    from rt1_tpu_torch.configs import apply_override, get_config

    cfg = get_config(name)
    for assignment in overrides:
        apply_override(cfg, assignment)
    return cfg


def build_state(cfg, weights, grid):
    """(state, fns) of `cfg` at `weights` (a state_dict), sharded per `grid`."""
    from rt1_tpu_torch.eval.restore import build_policy
    from rt1_tpu_torch.trainer.optim import Adam
    from rt1_tpu_torch.trainer.state import create_train_state, shard_train_state
    from rt1_tpu_torch.trainer.train import train_step_fns_from_config

    policy = build_policy(cfg)
    policy.load_state_dict(weights)
    partition = None
    if grid is not None:
        from rt1_tpu_torch.parallel.partition import partition_policy
        from rt1_tpu_torch.parallel.plan import ShardingPlan

        partition = partition_policy(policy, grid, ShardingPlan.from_config(cfg),
                                     cfg.model.pipeline_microbatches)
    if cfg.model.family == "lava":
        from rt1_tpu_torch.trainer.bc import make_bc_optimizer

        optimizer = make_bc_optimizer(learning_rate=OPT["learning_rate"])
    else:
        optimizer = Adam(**OPT)
    state = create_train_state(policy, optimizer, partition)
    if grid is not None and grid.size("fsdp") > 1:
        shard_train_state(state, grid.index("fsdp"), grid.size("fsdp"), optimizer)
    fns = train_step_fns_from_config(cfg, optimizer, grid=grid)
    return state, fns


def run_steps(spec, distributed=True):
    """Steps of `spec` on this rank's rows (or, without `distributed`, on
    the whole batch in one process); returns what the tests compare."""
    from rt1_tpu_torch.obs.health import PACK_KEY
    from rt1_tpu_torch.parallel import mesh
    from rt1_tpu_torch.parallel.plan import ShardingPlan

    cfg = make_config(spec["config"], spec["overrides"])
    grid = None
    if distributed:
        grid = mesh.RankGrid(ShardingPlan.from_config(cfg).mesh)
        mesh.set_current(grid)
    try:
        state, fns = build_state(cfg, spec["weights"], grid)
        block, blocks = (grid.batch_index, grid.batch_ways) if grid is not None else (0, 1)
        out = {"losses": [], "grads": [], "grad_norms": [], "action_loss_mean": []}
        for step, batch in enumerate(spec["batches"]):
            local = rows(batch, block, blocks, spec.get("order"))
            metrics = fns.train_step(state, local, step, keep_grad=True)
            out["losses"].append(metrics["loss"].detach().clone())
            out["grads"].append(full_flat(state, fns, metrics["grad"]).detach().clone())
            out["grad_norms"].append(metrics["grad_norm"].detach().clone())
            if "action_loss_mean" in metrics:
                out["action_loss_mean"].append(metrics["action_loss_mean"].detach().clone())
            if "moe_aux_loss" in metrics:
                out.setdefault("moe_aux_loss", []).append(metrics["moe_aux_loss"].detach().clone())
            if PACK_KEY in metrics:
                out.setdefault("packs", []).append(metrics[PACK_KEY].detach().clone())
                out["pack_names"] = list(fns.health_names(state))
        out["state"] = logical_state(state, fns)
        out["names"] = list(state.names)
        out["buffer_names"] = [n for n, b in state.policy.named_buffers()
                               if b.is_floating_point()]
        if spec.get("routers"):
            _, _, kept = fns._compute_copy(state, requires_grad=False)
            out["routers"] = {state.names[i]: t.detach().clone() for i, t in kept.items()}
        if grid is not None:
            out["grid"] = {"coords": grid.coords, "batch_index": grid.batch_index}
            out["flat_dtype"] = str(state.flat.dtype)
            out["flat_numel"] = state.flat.numel()
        return _with_part(out, state)
    finally:
        if distributed:
            mesh.set_current(None)


def assemble_parts(results, pick):
    """The logical flat vector of the world of one's layout from every
    rank's result (`run_steps`, `ckpt_save`, `ckpt_restore` under tp or
    pp: its "partition" and "part") and `pick(result)`, that rank's flat
    vector of its part."""
    from rt1_tpu_torch.parallel.partition import Partition

    partition = Partition.from_manifest(results[0]["partition"])
    return partition.logical_flat({tuple(got["part"]): pick(got) for got in results})


def logical_state_of(results):
    """Every rank's `logical_state` (each the rank's part) as the world of
    one's."""
    first = results[0]
    if "partition" not in first:
        return first["state"]
    out = dict(first["state"])
    for key in ("flat", "mu", "nu"):
        out[key] = assemble_parts(results, lambda got, key=key: got["state"][key])
    return out


def logical_result(results, name):
    """The result of check `name` with every rank's part (under tp or pp)
    assembled into the world of one's layout: gradients, masters and
    moments as logical flat vectors, as `run_steps` returns them for the
    world of one."""
    per_rank = [res[name] for res in results]
    first = per_rank[0]
    if "partition" not in first:
        return first
    out = dict(first, state=logical_state_of(per_rank), names=first["partition"]["names"])
    out["grads"] = [assemble_parts(per_rank, lambda got, i=i: got["grads"][i])
                    for i in range(len(first["grads"]))]
    return out


def _with_part(out, state):
    if state.partition is not None:
        out["partition"] = state.partition.to_manifest()
        out["part"] = (state.partition.stage_index, state.partition.model_index)
    return out


def step_checks(rank, world, payload):
    """Each spec of `payload["checks"]` in turn (see `run_steps`)."""
    return {name: run_steps(spec) for name, spec in payload["checks"].items()}


def preempt_one_rank(rank, world, payload):
    """The train loop on every rank, a SIGTERM (the fault plan) on rank
    `payload["signalled"]` alone at step index `payload["at"]`; returns
    the records rank 0 logs and where this rank's state stopped."""
    from rt1_tpu_torch.train.train import train_and_evaluate

    overrides = list(payload["overrides"])
    if rank == payload["signalled"]:
        overrides.append(f"resilience.faults=sigterm@{payload['at']}")
    records = []
    state = train_and_evaluate(make_config("tiny", overrides), payload["workdir"],
                               device="cpu", log=records.append)
    return {"records": records, "step": int(state.step)}


# ----------------------------------------------------------------- checkpoints


def _no_provenance(step, grid):
    raise AssertionError("only rank 0 writes the provenance")


def ckpt_save(rank, world, payload):
    """Initialise the state of `payload["config"]` under its plan, take
    `steps` steps (none: the seeded init), save at step `save_step`; return
    the logical state."""
    from rt1_tpu_torch.parallel import mesh
    from rt1_tpu_torch.parallel.plan import ShardingPlan
    from rt1_tpu_torch.trainer.checkpoints import CheckpointManager

    cfg = make_config(payload["config"], payload["overrides"])
    grid = mesh.RankGrid(ShardingPlan.from_config(cfg).mesh)
    state, fns = build_state(cfg, payload["weights"], grid)
    for step, batch in enumerate(payload.get("batches", [])):
        fns.train_step(state, rows(batch, grid.batch_index, grid.batch_ways), step)
    manager = CheckpointManager(payload["directory"], grid=grid)
    if rank != 0:
        manager._write_provenance = _no_provenance
    manager.save(payload["save_step"], state)
    if payload.get("torn_step") is not None:  # a save that never reached its manifest
        torn = os.path.join(payload["directory"], str(payload["torn_step"]))
        os.makedirs(torn, exist_ok=True)
        with open(os.path.join(torn, f"shard_{rank:05d}_of_{world:05d}.pt"), "wb") as f:
            f.write(b"partial")
    return _with_part({"state": logical_state(state, fns), "coords": grid.coords}, state)


def ckpt_restore(rank, world, payload):
    """Restore the newest step into a fresh state of `payload["config"]`
    under its plan; return the logical state and the step."""
    from rt1_tpu_torch.parallel import mesh
    from rt1_tpu_torch.parallel.plan import ShardingPlan
    from rt1_tpu_torch.trainer.checkpoints import CheckpointManager

    cfg = make_config(payload["config"], payload["overrides"])
    grid = mesh.RankGrid(ShardingPlan.from_config(cfg).mesh)
    state, fns = build_state(cfg, payload["weights"], grid)
    manager = CheckpointManager(payload["directory"], grid=grid)
    if rank != 0:
        manager._write_provenance = _no_provenance
    state, step = manager.restore_or_initialize(state)
    out = _with_part({"state": logical_state(state, fns), "step": step,
                      "chunk": state.flat.detach().clone(), "coords": grid.coords}, state)
    if payload.get("save_step") is not None:  # and write it again under this plan
        manager.save(payload["save_step"], state)
    return out


def ckpt_chain(rank, world, payload):
    """`ckpt_restore` under each plan of `payload["chain"]` in turn, each
    saving the state it restored as the next step."""
    return [ckpt_restore(rank, world, dict(payload, **link)) for link in payload["chain"]]


def ckpt_jobs(rank, world, payload):
    """Each of `payload["jobs"]` in turn: a `ckpt_save` ("save") or a
    `ckpt_chain` ("chain") payload."""
    run = {"save": ckpt_save, "chain": ckpt_chain}
    return [run[job["kind"]](rank, world, job) for job in payload["jobs"]]


# ----------------------------------------------------------------- the pipeline


def dense_stage_fn(p, x):
    """JAX's test stage: tanh(x @ w + b)."""
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_checks(rank, world, payload):
    """`pipeline_apply` of `dense_stage_fn` on each case (a data x stage
    grid over the world): this rank's output, input gradient and stack
    gradient of sum(out ** 2) on its data row's block of `x`; then the
    policy steps of `payload["checks"]` (`run_steps`) and the eval logits
    of `payload["logits"]` (`policy_logits`)."""
    from rt1_tpu_torch.parallel import mesh
    from rt1_tpu_torch.parallel.pipeline import pipeline_apply

    out = {}
    for name, case in payload.get("cases", {}).items():
        grid = mesh.RankGrid(mesh.MeshConfig(data=case.get("data", 1), stage=case["stages"]))
        stacked = {k: torch.from_numpy(v).requires_grad_(True) for k, v in case["params"].items()}
        data = grid.coords["data"]
        n = case["x"].shape[0] // grid.size("data")
        x = torch.from_numpy(case["x"][data * n:(data + 1) * n]).requires_grad_(True)
        y = pipeline_apply(dense_stage_fn, stacked, x, group=grid.group("stage"),
                           num_microbatches=case["microbatches"])
        (y ** 2).sum().backward()
        out[name] = {"y": y.detach(), "dx": x.grad, "coords": grid.coords,
                     "grads": {k: v.grad for k, v in stacked.items()}}
    for name, spec in payload.get("checks", {}).items():
        out[name] = run_steps(spec)
    for name, spec in payload.get("logits", {}).items():
        out[name] = policy_logits(spec)
    return out


def policy_logits(spec):
    """The eval-mode action logits of `spec`'s policy under its plan (the
    partitioned policy, outside the train step)."""
    from rt1_tpu_torch.eval.restore import build_policy
    from rt1_tpu_torch.parallel import mesh
    from rt1_tpu_torch.parallel.partition import partition_policy
    from rt1_tpu_torch.parallel.plan import ShardingPlan

    cfg = make_config(spec["config"], spec["overrides"])
    plan = ShardingPlan.from_config(cfg)
    grid = mesh.RankGrid(plan.mesh)
    policy = build_policy(cfg)
    policy.load_state_dict(spec["weights"])
    partition_policy(policy, grid, plan, cfg.model.pipeline_microbatches)
    obs, actions = rows(spec["batch"], 0, 1)
    with torch.no_grad():
        return policy(obs, actions, train=False)["action_logits"]


# ----------------------------------------------------------------- ring attention


def ring_checks(rank, world, payload):
    """The port's ring over every rank (S = world) on each case: outputs
    and the gradients of sum(out * cot) in q, k and v."""
    import torch.distributed as dist

    from rt1_tpu_torch.parallel.ring_attention import ring_attention

    group = dist.new_group(list(range(world)))
    out = {}
    for name, case in payload["cases"].items():
        q, k, v = (torch.from_numpy(case[x]).requires_grad_(True) for x in ("q", "k", "v"))
        mask = torch.from_numpy(case["mask"]) if case.get("mask") is not None else None
        y = ring_attention(q, k, v, mask=mask, group=group)
        (y * torch.from_numpy(case["cot"])).sum().backward()
        out[name] = {"out": y.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    q = torch.zeros(1, 3 * world + 1, 2, 4)
    try:
        ring_attention(q, q, q, group=group)
        out["indivisible"] = None
    except ValueError as exc:
        out["indivisible"] = str(exc)
    if payload.get("policy") is not None:
        out["policy"] = policy_ring(payload["policy"])
    if payload.get("step") is not None:   # a train step with sp = world
        out["step"] = run_steps(payload["step"])
    return out


def policy_ring(spec):
    """The RT-1 policy's eval loss and train loss and gradient with
    attention_impl "ring" over the seq ranks (`spec["overrides"]` sets sp)."""
    from rt1_tpu_torch.eval.restore import build_policy
    from rt1_tpu_torch.parallel import mesh
    from rt1_tpu_torch.parallel.plan import ShardingPlan

    from rt1_tpu_torch.parallel import ring_attention as ring_lib

    cfg = make_config(spec["config"], spec["overrides"])
    grid = mesh.RankGrid(ShardingPlan.from_config(cfg).mesh)
    mesh.set_current(grid)
    calls = []
    apply = ring_lib._RingAttention.apply
    ring_lib._RingAttention.apply = staticmethod(lambda *a: calls.append(1) or apply(*a))
    try:
        policy = build_policy(cfg)
        policy.load_state_dict(spec["weights"])
        obs, actions = rows(spec["batch"], 0, 1)
        with torch.no_grad():
            eval_loss = policy(obs, actions, train=False)["loss"]
        policy.zero_grad()
        loss = policy(obs, actions, train=True, rngs={})["loss"]
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in policy.named_parameters()}
        return {"eval_loss": eval_loss, "train_loss": loss.detach(), "grads": grads,
                "ring_calls": len(calls)}
    finally:
        ring_lib._RingAttention.apply = apply
        mesh.set_current(None)
