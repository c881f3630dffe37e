"""Switch-routed expert feed-forward (counterpart of `rt1_tpu/models/moe.py`).

Top-1 routing with a fixed per-expert capacity, in the JAX module's dense
formulation (no gather or scatter):

  gates    = softmax(x @ w_gate)                  (t, E), float32
  dispatch = one_hot(top1) * within-capacity mask  (t, E, C)
  buffers  = einsum('tec,td->ecd')                 (E, C, d)
  expert   = gelu(buffers @ wi) @ wo               batched over E
  out      = einsum('tec,ecd->td')                 gate-weighted combine

Routing is exactly JAX's: the router runs in float32 whatever the compute
dtype, argmax ties go to the first expert, a token's queue position is a
cumsum over the flattened (b, s) order, `capacity = int(factor * t / E)
or 1`, and tokens past an expert's capacity get combine weight 0 (they
fall through the block's residual). The GELU is the tanh form
(`jax.nn.gelu`'s default); dispatch and combine run in the compute dtype,
with the gate cast to it before the multiply.

Capacity binds per CALL, over its `t` tokens. `per_row=True` routes each
row of the batch as a call of its own (capacity over that row's tokens,
queues per row): the JAX serving engine vmaps a batch-1 step, so there a
session's routing never depends on the other sessions of its bucket or on
the padding lanes, and the port's engine, which steps a bucket as one
batch, asks for that. Training and a direct `infer_step` route the whole
call, as JAX does.

`aux_loss` is the Switch load-balancing loss, E * sum_e (fraction routed
to e) * (mean gate of e), in float32 (of the whole call; per row it is the
mean over rows, unused: only training reads it).

Inside the train step's `parallel.collectives.batch_shard` of several
ranks (data parallelism, a rank holding block `index` of the global
batch), a call routes the GLOBAL batch's tokens, as JAX's GSPMD step does:
the ranks all-reduce their per-expert counts (no gradient flows through
them), the capacity is the global call's, and a token's queue position
counts the tokens of every earlier block first. Each rank computes only
its own tokens, in buffers of the global capacity. `aux_loss` is then this
rank's part of the global loss, E * sum_e (global fraction routed to e) *
(the sum of this rank's gates of e / the global token count): linear in
the rank's gates, so the parts sum to the global loss and its gradient
(`trainer/train.py` weights the part so that it survives the step's
reduction).

Under tensor parallelism (`parallel.tp`, the plan's `P('model', ...)` on
`wi` and `wo`) a rank holds `num_experts / tp` of the experts
(`parallel/partition.py`). The float32 router stays whole, so every model
rank routes identically (routing, capacity and queue order as above) and
computes the same aux loss, which therefore enters the loss once. Each
rank runs only the tokens routed to its experts (`copy_in` of the
tokens); the ungated outputs are summed over `model` (`reduce_out`: each
token's lies on one rank) and then gated by the whole router's gate, so
the router's gradient is whole on every model rank too. In float32 this
is the world of one's output bit for bit: a token's combine sums one
nonzero product either way.

The stacked experts keep JAX's layout, `wi` (E, d, ff) and `wo` (E, ff,
d), as plain parameters. For int8 serving (`models/quant.py`) they
quantize per output column over every other axis, one scale per column
shared by the experts (`wi_scale` (ff,), `wo_scale` (d,)), as JAX's
`quantize_per_channel` does on the same arrays; the float32 router is
never quantized.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rt1_tpu_torch.parallel import tensor_parallel as tp
from rt1_tpu_torch.parallel.collectives import current_batch_shard

QUANT_PARAMS = ("wi", "wo")


class Router(nn.Linear):
    """The routing Dense (no bias). A float cast of the model (`.to(dtype)`,
    `.bfloat16()`) leaves its weight float32 and exact, as JAX's
    `dtype=float32` Dense keeps float32 params whatever the model's dtype.
    A bf16 serving tree holds its values rounded to bfloat16 (still at
    float32, `quant.serving_preparer`); it computes in float32 either way."""

    def _apply(self, fn, recurse=True):
        def keep_float32(t):
            out = fn(t)
            if out.is_floating_point() and out.dtype != torch.float32:
                return t.to(device=out.device, dtype=torch.float32)
            return out

        return super()._apply(keep_float32, recurse)


def _counts_by_block(counts: torch.Tensor, group, index: int, ways: int) -> torch.Tensor:
    """(ways, e): row i the per-expert token counts of block i of the
    global batch, all-reduced over `group` (`counts` is this block's)."""
    import torch.distributed as dist

    rows = torch.zeros(ways, counts.numel(), dtype=counts.dtype, device=counts.device)
    rows[index] = counts.detach()
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    return rows


def router_names(model: nn.Module) -> List[str]:
    """The parameter names of `model`'s MoE routers, the leaves that stay
    float32 when the rest computes in bfloat16."""
    return [f"{name}.{leaf}" if name else leaf
            for name, module in model.named_modules() if isinstance(module, Router)
            for leaf, _ in module.named_parameters()]


class MoEFeedForward(nn.Module):
    """Top-1 routed expert FFN: d_model -> ff_dim (gelu) -> d_model."""

    def __init__(self, d_model: int, num_experts: int = 4, ff_dim: Optional[int] = None,
                 capacity_factor: float = 2.0):
        super().__init__()
        ff = ff_dim or d_model
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.gate = Router(d_model, num_experts, bias=False)
        self.wi = nn.Parameter(torch.empty(num_experts, d_model, ff))
        self.wo = nn.Parameter(torch.empty(num_experts, ff, d_model))
        self.register_buffer("wi_scale", None)
        self.register_buffer("wo_scale", None)
        self._compute_dtype = torch.float32

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.wi.dtype if self.wi.is_floating_point() else self._compute_dtype

    def expert_weight(self, name: str) -> torch.Tensor:
        """`wi` or `wo` in the compute dtype; an int8 one dequantized in
        float32 through its per-column scale first."""
        w = getattr(self, name)
        if w.dtype != torch.int8:
            return w
        scale = getattr(self, name + "_scale")
        if scale is None:
            raise ValueError(f"MoEFeedForward.{name} is int8 but {name}_scale is not set")
        return (w.to(scale.dtype) * scale).to(self._compute_dtype)

    def set_int8_(self, name: str, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Hold `q` (int8, the parameter's shape) and its (last-dim) scale in
        place of the float `wi` or `wo`."""
        w = getattr(self, name)
        if q.dtype != torch.int8 or tuple(q.shape) != tuple(w.shape):
            raise ValueError(f"int8 {name} {tuple(q.shape)}/{q.dtype} does not fit {tuple(w.shape)}")
        self._compute_dtype = self.compute_dtype
        setattr(self, name, nn.Parameter(q, requires_grad=False))
        setattr(self, name + "_scale", scale)

    def forward(self, x: torch.Tensor, per_row: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (b, s, d) -> (out (b, s, d) in the compute dtype, aux_loss
        float32 scalar)."""
        b, s, d = x.shape
        e = self.num_experts
        dtype = self.compute_dtype
        groups, t = (b, s) if per_row else (1, b * s)
        group, index, ways = (None, 0, 1) if per_row else current_batch_shard()
        tokens = x.reshape(groups, t, d)
        gate_logits = F.linear(tokens.float(), self.gate.weight.float())
        gates = torch.softmax(gate_logits, dim=-1)                      # (g, t, e)
        expert_idx = torch.argmax(gates, dim=-1)                        # first max on ties
        expert_gate = torch.amax(gates, dim=-1)
        one_hot = F.one_hot(expert_idx, e).to(torch.float32)            # (g, t, e)
        queue = torch.cumsum(one_hot, dim=1) - 1.0
        if ways == 1:
            density = one_hot.mean(dim=1)
            density_proxy = gates.mean(dim=1)
            aux_loss = ((density * density_proxy).sum(dim=-1) * e).mean()
            capacity = int(self.capacity_factor * t / e) or 1
        else:
            # Block `index` of the global batch: route the global call.
            counts = _counts_by_block(one_hot[0].sum(dim=0), group, index, ways)  # (ways, e)
            t_global = t * ways
            density = counts.sum(dim=0) / t_global
            aux_loss = (density * gates[0].sum(dim=0) / t_global).sum() * e
            capacity = int(self.capacity_factor * t_global / e) or 1
            queue = queue + counts[:index].sum(dim=0)
        position_in_expert = queue * one_hot
        slots = torch.arange(capacity, device=x.device, dtype=torch.float32)
        # A position >= capacity matches no slot: the token is dropped.
        pos_one_hot = (position_in_expert.sum(dim=-1)[..., None] == slots).to(torch.float32)
        dispatch = (one_hot[..., None] * pos_one_hot[..., None, :]).to(dtype)  # (g, t, e, c)

        local = self.wi.shape[0]   # this rank's experts
        if tp.split_ways(local, e) > 1:
            lo = tp.model_index() * local
            dispatch = dispatch[:, :, lo:lo + local]
            expert_out = self._experts(dispatch, tp.copy_in(tokens.to(dtype)))
            out = tp.reduce_out(torch.einsum("gtec,gecd->gtd", dispatch, expert_out))
            out = out * expert_gate.to(dtype)[..., None]
            return out.reshape(b, s, d), aux_loss
        expert_out = self._experts(dispatch, tokens.to(dtype))
        combine = dispatch * expert_gate.to(dtype)[..., None, None]
        out = torch.einsum("gtec,gecd->gtd", combine, expert_out)
        return out.reshape(b, s, d), aux_loss

    def _experts(self, dispatch: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """(g, e, c, d): each held expert's FFN on its capacity buffer."""
        buffers = torch.einsum("gtec,gtd->gecd", dispatch, tokens)
        h = F.gelu(torch.einsum("gecd,edf->gecf", buffers, self.expert_weight("wi")),
                   approximate="tanh")
        return torch.einsum("gecf,efd->gecd", h, self.expert_weight("wo"))
