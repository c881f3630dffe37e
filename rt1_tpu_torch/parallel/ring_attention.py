"""Ring attention: exact attention with the window split over the `seq`
ranks (counterpart of `rt1_tpu/parallel/ring_attention.py`).

JAX shards q/k/v over the mesh's `seq` axis inside `shard_map` and rotates
the k/v blocks with `ppermute`. Here each of the S ranks of a `seq` process
group holds the whole (b, t, h, d) q/k/v (the decoder computes them on
every seq rank), takes its query chunk i and its k/v chunk i, and passes
the k/v blocks around the ring with `batch_isend_irecv`: S - 1 hops, block
i sent to rank i - 1 and block i + 1 received, JAX's `perm`. Each hop folds
one block into a float32 online-softmax accumulator (masked logits -1e9,
as JAX's; a row with no weight gives 0, JAX's rule), with the (t, t) mask's
(query chunk, key chunk) block. The chunks' outputs are then all-gathered,
so the layer's output equals dense attention's on every rank.

Autograd does not differentiate through send and recv, so `_RingAttention`
is a `torch.autograd.Function` whose backward runs the reverse ring: each
rank recomputes every hop's probabilities from its saved row maxima and
softmax denominators (the log-sum-exp in two parts: a row whose every
logit is -1e9 keeps its exact 1/t weights, which the sum -1e9 + log t in
float32 would not), accumulates dq for its chunk, and adds its share of
dk and dv to accumulators that travel with the k/v blocks; one last hop
brings each block's accumulators home. The gradients of the chunks are
all-gathered back to (b, t, h, d), so every seq rank returns the whole
gradient of its (identical) inputs.

The ring runs no attention dropout, as JAX's does not.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def _ring_hop(tensor: torch.Tensor, group, tag: int) -> torch.Tensor:
    """Send `tensor` to the previous rank of `group` and return the next
    rank's (JAX's perm i -> i - 1)."""
    import torch.distributed as dist

    size, me = dist.get_world_size(group), dist.get_rank(group)
    send_to = dist.get_global_rank(group, (me - 1) % size)
    recv_from = dist.get_global_rank(group, (me + 1) % size)
    tensor = tensor.contiguous()
    received = torch.empty_like(tensor)
    ops = [dist.P2POp(dist.isend, tensor, send_to, group, tag),
           dist.P2POp(dist.irecv, received, recv_from, group, tag)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return received


def _mask_block(mask, row: int, col: int, n: int):
    return None if mask is None else mask[row * n:(row + 1) * n, col * n:(col + 1) * n]


def _logits(qs: torch.Tensor, k: torch.Tensor, block) -> torch.Tensor:
    logits = torch.einsum("bshd,bthd->bhst", qs, k.to(torch.float32))
    if block is not None:
        logits = torch.where(block[None, None] != 0, logits, NEG_INF)
    return logits


def ring_forward(q, k, v, mask, group, scale):
    """This rank's chunk of attention: (out (b, tl, h, d) float32, row
    maxima m and denominators l, both (b, h, tl)). q/k/v are this rank's
    chunks."""
    import torch.distributed as dist

    size, me = dist.get_world_size(group), dist.get_rank(group)
    b, n, h, d = q.shape
    qs = q.to(torch.float32) * scale
    o = torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, n), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, n), float("-inf"), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for s in range(size):
        src = (me + s) % size
        logits = _logits(qs, kv[0], _mask_block(mask, me, src, n))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhst,bthd->bhsd", p, kv[1].to(torch.float32))
        m = m_new
        if s < size - 1:
            kv = _ring_hop(kv, group, tag=0)
    out = torch.where(l[..., None] > 0, o / torch.clamp(l, min=1e-30)[..., None], 0.0)
    return out.transpose(1, 2), m, l


def ring_backward(dout, q, k, v, out, m, l, mask, group, scale):
    """(dq, dk, dv) of this rank's chunks, float32, by the reverse ring."""
    import torch.distributed as dist

    size, me = dist.get_world_size(group), dist.get_rank(group)
    n = q.shape[1]
    qf = q.to(torch.float32)
    qs = qf * scale
    do = dout.to(torch.float32)                              # (b, n, h, d)
    rowdot = torch.einsum("bshd,bshd->bhs", do, out)          # D = rowsum(dO * O)
    inv_l = torch.where(l > 0, 1.0 / torch.clamp(l, min=1e-30), 0.0)
    dq = torch.zeros_like(qf)
    kv = torch.stack([k, v])
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    for s in range(size):
        src = (me + s) % size
        block = _mask_block(mask, me, src, n)
        logits = _logits(qs, kv[0], block)
        p = torch.exp(logits - m[..., None]) * inv_l[..., None]
        dkv[1] += torch.einsum("bhst,bshd->bthd", p, do)
        dp = torch.einsum("bshd,bthd->bhst", do, kv[1].to(torch.float32))
        ds = p * (dp - rowdot[..., None])
        if block is not None:
            ds = torch.where(block[None, None] != 0, ds, 0.0)
        dq += torch.einsum("bhst,bthd->bshd", ds, kv[0].to(torch.float32)) * scale
        dkv[0] += torch.einsum("bhst,bshd->bthd", ds, qf) * scale
        if s < size - 1:
            kv = _ring_hop(kv, group, tag=0)
        dkv = _ring_hop(dkv, group, tag=1)   # the last hop brings each block's home
    return dq, dkv[0], dkv[1]


def _gather_seq(chunk: torch.Tensor, group) -> torch.Tensor:
    """(b, t, ...) from every rank's (b, t / S, ...) chunk, in rank order."""
    import torch.distributed as dist

    size = dist.get_world_size(group)
    chunk = chunk.contiguous()
    out = torch.empty((size,) + tuple(chunk.shape), dtype=chunk.dtype, device=chunk.device)
    dist.all_gather_into_tensor(out.view(-1), chunk.view(-1), group=group)
    return torch.cat(out.unbind(0), dim=1)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, group, scale):
        import torch.distributed as dist

        size, me = dist.get_world_size(group), dist.get_rank(group)
        n = q.shape[1] // size
        cut = slice(me * n, (me + 1) * n)
        qc, kc, vc = q[:, cut], k[:, cut], v[:, cut]
        out, m, l = ring_forward(qc, kc, vc, mask, group, scale)
        ctx.save_for_backward(qc, kc, vc, out, m, l, mask if mask is not None else torch.empty(0))
        ctx.has_mask, ctx.group, ctx.scale, ctx.cut = mask is not None, group, scale, cut
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        return _gather_seq(out.to(q.dtype), group)

    @staticmethod
    def backward(ctx, dout):
        qc, kc, vc, out, m, l, mask = ctx.saved_tensors
        dq, dk, dv = ring_backward(dout[:, ctx.cut], qc, kc, vc, out, m, l,
                                   mask if ctx.has_mask else None, ctx.group, ctx.scale)
        grads = [_gather_seq(g.to(dt), ctx.group) for g, dt in zip((dq, dk, dv), ctx.dtypes)]
        return grads[0], grads[1], grads[2], None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, group=None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact multi-head attention with the sequence split over the ranks
    of `group` (default: the `seq` group of `parallel.mesh.current()`).

    q, k, v: (b, t, h, d), the same on every rank of the group; t must
    divide by its size. mask: optional (t, t), nonzero = attend. scale:
    default 1/sqrt(d). Returns (b, t, h, d) in q's dtype, the same on
    every rank; differentiable in q, k and v."""
    import torch.distributed as dist

    if group is None:
        from rt1_tpu_torch.parallel import mesh

        grid = mesh.current()
        group = grid.group("seq") if grid is not None else None
    if group is None:
        raise ValueError("ring_attention needs a seq process group (parallel.mesh.current())")
    size = dist.get_world_size(group)
    t = q.shape[1]
    if t % size != 0:
        raise ValueError(f"seq len {t} not divisible by seq={size}")
    if mask is not None and mask.dim() != 2:
        raise ValueError("ring attention supports (s, s) masks only")
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    return _RingAttention.apply(q, k, v, mask, group, float(scale))


def dense_attention_reference(q, k, v, mask=None, scale=None):
    """Single-device reference (JAX's `dense_attention_reference`)."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32), k.to(torch.float32)) * scale
    if mask is not None:
        logits = torch.where(mask[None, None] != 0, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, v.to(torch.float32)).to(q.dtype)


def seq_group_size() -> int:
    """Ranks of the current grid's `seq` axis (1 without a grid)."""
    from rt1_tpu_torch.parallel import mesh

    grid = mesh.current()
    return grid.size("seq") if grid is not None else 1
