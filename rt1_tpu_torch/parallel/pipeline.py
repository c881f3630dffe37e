"""Pipeline parallelism: GPipe over the grid's `stage` ranks
(counterpart of `rt1_tpu/parallel/pipeline.py`).

JAX rotates microbatches between stages with `ppermute` inside a
`shard_map` and lets autodiff pipeline the backward pass. The port runs
the same schedule by hand over `torch.distributed` point to point
(`batch_isend_irecv`, as the ring attention does), in a
`torch.autograd.Function` whose backward runs it in reverse:

  tick t:  stage 0 takes microbatch t; stage s computes the microbatch it
           received from stage s - 1 at the end of tick t - 1, and sends
           its output on to stage s + 1; after M + S - 1 ticks every
           microbatch has crossed all S stages, and the last stage's
           output is broadcast to every stage rank.

  backward: the ticks in reverse; the last stage takes its own output's
           cotangent (every stage rank computed the same head and loss,
           so the cotangent enters once), each stage backpropagates a
           microbatch through its layers (the graph its forward recorded)
           and sends the input's cotangent to stage s - 1; stage 0's input
           cotangent is broadcast to every stage rank.

So every stage rank ends with the world of one's gradient of whatever
runs whole before and after the stack (the vision tower, the embeddings,
the head), and each stage with its own layers' gradient. S = 1 (no group)
is a plain loop over the layers on the whole batch. The bubble is GPipe's
(S - 1)/(M + S - 1); every microbatch's activations live until the
backward, as in GPipe.

`pp_causal_transformer_apply` runs a `CausalTransformer` whose layers the
partition split over the stages (`parallel/partition.py`): the
embeddings and the head whole on every stage rank, the stage's layers
pipelined. JAX's refusals are kept by name: attention other than
"dense", training with `ffn_impl="moe"` (JAX loses the aux loss inside its
stage; the port keeps the refusal), and dropout in train mode without its
generator. `model.remat` is honoured. Inside the stage each data shard
pipelines its own rows (dropout masks, and a MoE's capacity in eval, are
the microbatch's, JAX's per-shard semantics); the `model` axis is kept, so
tensor parallelism composes with the stages.

Dropout follows JAX's contract: a mask per (layer, microbatch, data
shard), each from a generator of its own seeded from the step's dropout
generator and those three indices, equal in distribution to the
sequential module's masks, not equal bit for bit (dropout 0 is exact).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from rt1_tpu_torch.parallel.collectives import (
    current_batch_shard,
    current_shard,
    shard_context,
)


@dataclasses.dataclass
class StagePlan:
    """A rank's stage: the `stage` process group, its index and size, the
    global indices of the layers it holds, and the microbatches a call."""

    group: Any
    index: int
    ways: int
    layers: range
    microbatches: int


def stack_layer_params(params: Mapping[str, torch.Tensor], num_layers: int,
                       prefix: str = "layer_") -> Dict[str, torch.Tensor]:
    """{leaf name within a layer: (num_layers, ...)} from a decoder's
    parameters keyed `<prefix><i>.<leaf>` (a `CausalTransformer`'s
    state_dict): the layout `pipeline_apply` splits over the stages."""
    per_layer: List[Dict[str, torch.Tensor]] = [{} for _ in range(num_layers)]
    for key, value in params.items():
        if not key.startswith(prefix):
            continue
        index, leaf = key[len(prefix):].split(".", 1)
        if int(index) < num_layers:
            per_layer[int(index)][leaf] = value
    return {leaf: torch.stack([layer[leaf] for layer in per_layer])
            for leaf in per_layer[0]}


def unstack_layer_params(stacked: Mapping[str, torch.Tensor],
                         prefix: str = "layer_") -> Dict[str, torch.Tensor]:
    """The inverse of `stack_layer_params`."""
    num_layers = next(iter(stacked.values())).shape[0]
    return {f"{prefix}{i}.{leaf}": value[i] for i in range(num_layers)
            for leaf, value in stacked.items()}


def _exchange(group, send: Optional[torch.Tensor], send_to: int,
              recv_like: Optional[torch.Tensor], recv_from: int) -> Optional[torch.Tensor]:
    """Send `send` to stage `send_to` and receive a tensor like `recv_like`
    from stage `recv_from` (either may be None), both in one batch."""
    import torch.distributed as dist

    ops, received = [], None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, send_to), group))
    if recv_like is not None:
        received = torch.empty_like(recv_like)
        ops.append(dist.P2POp(dist.irecv, received, dist.get_global_rank(group, recv_from),
                              group))
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()
    return received


def _broadcast(t: torch.Tensor, plan: StagePlan, src: int) -> torch.Tensor:
    import torch.distributed as dist

    t = t.contiguous()
    dist.broadcast(t, src=dist.get_global_rank(plan.group, src), group=plan.group)
    return t


def _forward_schedule(run_stage: Callable, plan: StagePlan, x: torch.Tensor, record: bool):
    """The forward ticks on this stage: (the last stage's output on every
    stage rank, each microbatch's (input leaf, output) graph if `record`)."""
    S, s, M = plan.ways, plan.index, plan.microbatches
    feed = x.detach().chunk(M)
    graphs: List[Any] = [None] * M
    outs: List[Optional[torch.Tensor]] = [None] * M
    incoming = None
    for t in range(M + S - 1):
        m = t - s
        y = None
        if 0 <= m < M:
            inp = feed[m] if s == 0 else incoming
            if record:
                leaf = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = run_stage(leaf, m)
                graphs[m] = (leaf, y)
                y = y.detach()
            else:
                y = run_stage(inp, m)
            if s == S - 1:
                outs[m] = y
        incoming = _exchange(plan.group, y if s < S - 1 else None, s + 1,
                             feed[0] if s > 0 and 0 <= t + 1 - s < M else None, s - 1)
    out = torch.cat(outs) if s == S - 1 else torch.empty_like(x)
    return _broadcast(out, plan, S - 1), graphs


class _GPipe(torch.autograd.Function):
    """The pipelined stack, differentiable in its input and in `params`
    (the tensors the stage's layers read)."""

    @staticmethod
    def forward(ctx, run_stage, plan, x, *params):
        out, graphs = _forward_schedule(run_stage, plan, x, record=True)
        ctx.plan, ctx.graphs, ctx.params = plan, graphs, params
        return out

    @staticmethod
    def backward(ctx, dy):
        plan, graphs, params = ctx.plan, ctx.graphs, ctx.params
        S, s, M = plan.ways, plan.index, plan.microbatches
        dys = dy.chunk(M)
        sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
        dxs: List[Optional[torch.Tensor]] = [None] * M
        incoming = None
        with torch.enable_grad():
            for t in reversed(range(M + S - 1)):
                m = t - s
                dx = None
                if 0 <= m < M:
                    leaf, y = graphs[m]
                    g = dys[m] if s == S - 1 else incoming
                    grads = torch.autograd.grad(y, [leaf, *params], g, allow_unused=True)
                    graphs[m] = None
                    dx = grads[0]
                    for acc, grad in zip(sums, grads[1:]):
                        if grad is not None:
                            acc += grad.to(torch.float32)
                    if s == 0:
                        dxs[m] = dx
                incoming = _exchange(plan.group, dx if s > 0 else None, s - 1,
                                     dys[0] if s < S - 1 and 0 <= t - 1 - s < M else None,
                                     s + 1)
        dx = torch.cat(dxs) if s == 0 else torch.empty_like(dy)
        dx = _broadcast(dx.to(dy.dtype), plan, 0)
        return (None, None, dx, *[acc.to(p.dtype) for acc, p in zip(sums, params)])


def run_pipeline(run_stage: Callable[[torch.Tensor, int], torch.Tensor], plan: StagePlan,
                 x: torch.Tensor, params) -> torch.Tensor:
    """`run_stage(x_microbatch, microbatch_index)` of every stage, in
    order, over `x`'s microbatches (see the module docstring); `params`
    the tensors `run_stage` reads that need a gradient."""
    if x.shape[0] % plan.microbatches:
        raise ValueError(f"per-shard batch {x.shape[0]} not divisible by "
                         f"num_microbatches={plan.microbatches}")
    params = [p for p in params if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        return _GPipe.apply(run_stage, plan, x, *params)
    return _forward_schedule(run_stage, plan, x, record=False)[0]


def pipeline_apply(stage_fn: Callable, stacked_params: Mapping[str, torch.Tensor],
                   x: torch.Tensor, *, group=None, num_microbatches: int = 1,
                   pass_context: bool = False) -> torch.Tensor:
    """Run `x` through the stacked layers (`stacked_params` leaves (L,
    ...), whole on every rank, as JAX's global array) pipelined over the
    ranks of `group` (the `stage` group): stage s applies
    `stage_fn(layer_params, h)` (`stage_fn(layer_params, h, layer_index,
    microbatch_index)` with `pass_context`) for its layers [s L/S, (s+1)
    L/S). Without a group of more than one rank, a plain loop over the L
    layers on the whole batch (microbatch index 0). Returns the last
    layer's output, the same on every rank; differentiable in `x` and in
    the stack (each rank's gradient holds its own layers' rows)."""
    import torch.distributed as dist

    num_layers = next(iter(stacked_params.values())).shape[0]

    def apply(layers, h, m):
        for i in layers:
            p = {k: v[i] for k, v in stacked_params.items()}
            h = stage_fn(p, h, i, m) if pass_context else stage_fn(p, h)
        return h

    S = dist.get_world_size(group) if group is not None else 1
    if S == 1:
        return apply(range(num_layers), x, 0)
    if num_layers % S:
        raise ValueError(f"{num_layers} stacked layers not divisible by {S} stages")
    s, per = dist.get_rank(group), num_layers // S
    plan = StagePlan(group=group, index=s, ways=S, layers=range(s * per, (s + 1) * per),
                     microbatches=num_microbatches)
    return run_pipeline(lambda h, m: apply(plan.layers, h, m), plan, x,
                        list(stacked_params.values()))


def _layer_rngs(base: int, layer: int, micro: int, shard: int, device):
    words = np.random.SeedSequence([base, layer, micro, shard]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return {"dropout": g}


def pp_causal_transformer_apply(transformer, inputs: torch.Tensor,
                                attention_mask: Optional[torch.Tensor] = None,
                                train: bool = False, rngs=None) -> torch.Tensor:
    """`CausalTransformer.forward`'s logits with the layer stack pipelined
    over `transformer.stages` (see the module docstring)."""
    from rt1_tpu_torch.ops.remat import checkpoint

    if transformer.attention_impl != "dense":
        raise ValueError("pipeline parallelism supports attention_impl='dense' only, "
                         f"got {transformer.attention_impl!r}")
    if train and transformer.ffn_impl == "moe":
        raise ValueError(
            "training with pipeline parallelism + MoE FFN is unsupported: the Switch aux "
            "loss inside the stage would be discarded; use ffn_impl='dense' under PP or "
            "train MoE on a stage=1 mesh")
    use_dropout = train and transformer.dropout_rate > 0
    if use_dropout and (not rngs or rngs.get("dropout") is None):
        raise ValueError("train=True with dropout_rate > 0 requires dropout_rng")
    plan = transformer.stages
    x = transformer.embed(inputs)
    layers = [(i, getattr(transformer, f"layer_{i}")) for i in plan.layers]
    base = rngs["dropout"].initial_seed() if use_dropout else 0
    _, shard_index, _ = current_batch_shard()
    # Each data shard pipelines its own rows; the model axis stays.
    local = dataclasses.replace(current_shard(), group=None, index=0, ways=1)

    def run_stage(h, m):
        with shard_context(local):
            for i, layer in layers:
                layer_rngs = _layer_rngs(base, i, m, shard_index, h.device) \
                    if use_dropout else None
                if transformer.remat and train:
                    h, _ = checkpoint(layer, h, attention_mask, train, layer_rngs, False,
                                      rngs=layer_rngs)
                else:
                    h, _ = layer(h, attention_mask, train, layer_rngs)
        return h

    params = [p for _, layer in layers for p in layer.parameters()]
    return transformer.head(run_pipeline(run_stage, plan, x, params))
