"""Causal decoder-only transformer for RT-1 (counterpart of
`rt1_tpu/models/transformer.py`).

* token embedding Dense(input_emb -> d_model) plus a learned position table;
* N pre-norm blocks: LayerNorm (eps 1e-6) -> tf.keras-style multi-head
  attention with per-head width `key_dim` decoupled from d_model ->
  residual; LayerNorm -> ONE Dense(d_model -> d_model) with no activation
  (the reference's quirk), or with `ffn_impl="moe"` the Switch-routed
  expert FFN (`models/moe.py`) -> dropout -> residual;
* output head Dense(d_model -> vocab).

Attention has two paths, each the counterpart of its JAX path:

* "dense": fp32 logits and softmax, probabilities cast to the compute
  dtype before the PV product (`transformer.py` dense branch);
* "fused": the hand-written kernel (`parallel/flash_attention.py`), which
  keeps the probabilities in fp32 (the JAX "pallas" branch). In bf16 the
  two paths therefore differ slightly, exactly as they do in JAX. The
  kernel is forward-only, so `train=True` takes the dense path, as the
  JAX "pallas" branch does;
* "ring": sequence-parallel over the `seq` ranks of the current rank grid
  (`parallel/ring_attention.py`), in train and eval mode, without
  attention dropout, as JAX's "ring" branch; with one `seq` rank (or no
  grid) the dense path, dropout included, as JAX without a `seq` axis.

`train=True` drops attention probabilities (fp32, before the cast) and
the FFN output at `dropout_rate`, drawing from `rngs["dropout"]`.

Tensor parallelism (`parallel.tp`, `parallel/partition.py` splits the
weights by the plan's `model` rules): a layer whose weights hold this
rank's block computes its part and moves activations with
`parallel/tensor_parallel.py`'s collectives, so its output is whole on
every model rank. Attention takes the rank's `num_heads / tp` heads
(`query`, `key`, `value` column blocks), its probabilities' dropout keeps
the rank's heads of the whole mask, and `out` is row-parallel (partial
sums all-reduced, the whole bias added once); `ff`, `token_emb` and
`output_tokens` are column-parallel and gathered; the MoE FFN holds
`num_experts / tp` experts (`models/moe.py`). `position_emb` and the
norms stay whole. Whole weights compute whole.

Pipeline parallelism (`parallel.pp`): with `stages` set (the partition
does, on a grid with a `stage` axis above 1) the layer stack runs GPipe
over the stage ranks (`parallel/pipeline.py`); this rank holds its
stage's layers only, and the embeddings and the head run whole on every
stage rank.

Incremental decode (`decode`, the JAX modules' `kv_cache`/`cache_index`
path): the input carries only the NEW positions; each layer writes their
k/v into its cache rows at `cache_index`, and the new queries attend the
whole cached prefix under a `(new, cache_len)` mask, with the dense math
(fp32 logits and softmax, P cast to the compute dtype, -1e9 fill), never
the kernel, as in JAX. The cache is one `(b, layers, 2, cache_len, heads,
key_dim)` tensor at the compute dtype (k at index 0 of dim 2, v at 1).
JAX writes at one scalar `cache_index` (its engine vmaps a batch-1 step);
the port's `cache_index` is per row, `(b,)`, so the write, the position
rows and the mask rows are per-row gathers and scatters.

Modules whose weights are int8 (`models/quant.py`) compute in the dtype
the quantizable layers record, and the projections dequantize at use.

Modules compute in the dtype of their weights; inputs are cast to it at
the first Dense, as flax's `dtype=` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rt1_tpu_torch.ops.dropout import Rngs, dropout
from rt1_tpu_torch.ops.remat import checkpoint
from rt1_tpu_torch.models.moe import MoEFeedForward
from rt1_tpu_torch.models.quant import QuantLinear
from rt1_tpu_torch.parallel import tensor_parallel as tp
from rt1_tpu_torch.parallel.flash_attention import fused_attention
from rt1_tpu_torch.parallel.ring_attention import ring_attention, seq_group_size

NEG_INF = -1e9
ATTENTION_IMPLS = ("dense", "fused", "ring")
FFN_IMPLS = ("dense", "moe")


def normalize_attention_impl(impl: str) -> str:
    """"pallas" (the JAX package's name for the fused kernel) -> "fused";
    "dense", "fused" and "ring" stay."""
    impl = "fused" if impl == "pallas" else impl
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS} or 'pallas', got {impl!r}")
    return impl


class TFMultiHeadAttention(nn.Module):
    """qkv project d_model -> heads*key_dim, out back to d_model."""

    def __init__(self, num_heads: int, key_dim: int, d_model: int, attention_impl: str = "dense",
                 dropout_rate: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.dropout_rate = dropout_rate
        self.attention_impl = normalize_attention_impl(attention_impl)
        self.query = QuantLinear(d_model, num_heads * key_dim)
        self.key = QuantLinear(d_model, num_heads * key_dim)
        self.value = QuantLinear(d_model, num_heads * key_dim)
        self.out = QuantLinear(num_heads * key_dim, d_model)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, rngs: Rngs = None) -> torch.Tensor:
        """x: (b, s, d_model); mask: (s, s), nonzero = attend."""
        b, s, _ = x.shape
        k = self.key_dim
        h = self.query.weight.shape[0] // k   # this rank's heads
        split = tp.split_ways(h, self.num_heads) > 1
        if split:
            x = tp.copy_in(x)
        q = self.query(x).view(b, s, h, k)
        kk = self.key(x).view(b, s, h, k)
        v = self.value(x).view(b, s, h, k)
        if self.attention_impl == "fused" and not train:
            out = fused_attention(q, kk, v, mask=mask, scale=1.0 / float(k) ** 0.5)
        elif self.attention_impl == "ring" and seq_group_size() > 1:
            out = ring_attention(q, kk, v, mask=mask, scale=1.0 / float(k) ** 0.5)
        else:
            logits = torch.einsum("bshd,bthd->bhst", q.float(), kk.float())
            logits = logits / float(k) ** 0.5
            if mask is not None:
                logits = torch.where(mask != 0, logits, NEG_INF)
            probs = dropout(torch.softmax(logits, dim=-1), self.dropout_rate, train, rngs,
                            model_dim=1 if split else None)
            out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
        out = out.reshape(b, s, h * k)
        if not split:
            return self.out(out)
        return tp.reduce_out(torch.nn.functional.linear(out, self.out.kernel())) + self.out.bias

    def decode(self, x: torch.Tensor, mask: torch.Tensor, kv_cache: torch.Tensor,
               cache_index: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (b, s, d_model) new positions; mask: (s, cache_len) or
        (b, s, cache_len), nonzero = attend; kv_cache: (b, 2, cache_len, h,
        key_dim); cache_index: (b,) first new position of each row. Returns
        the output and the updated cache."""
        b, s, _ = x.shape
        h, k = self.num_heads, self.key_dim
        q = self.query(x).view(b, s, h, k)
        rows = torch.arange(b, device=x.device)[:, None]
        positions = cache_index.to(torch.long)[:, None] + torch.arange(s, device=x.device)
        k_cache = kv_cache[:, 0].index_put((rows, positions), self.key(x).view(b, s, h, k))
        v_cache = kv_cache[:, 1].index_put((rows, positions), self.value(x).view(b, s, h, k))
        logits = torch.einsum("bqhd,bshd->bhqs", q.float(), k_cache.float()) / float(k) ** 0.5
        mask = mask if mask.dim() == 3 else mask[None]
        logits = torch.where(mask[:, None] != 0, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqs,bshd->bqhd", probs.to(v_cache.dtype), v_cache)
        return self.out(out.reshape(b, s, h * k)), torch.stack([k_cache, v_cache], dim=1)


class TransformerLayer(nn.Module):
    """Pre-norm block: x + MHA(LN(x)); x + FFN(LN(x)).

    `ffn_impl="dense"` is the reference's single square Dense (`ff`);
    `"moe"` is the Switch-routed expert FFN (`moe`, `models/moe.py`). Each
    call returns `(x, aux)`: the MoE's load-balancing loss, None for the
    dense FFN (JAX sows it into "intermediates"). `per_row` routes each
    row on its own (the serving engine's per-session capacity)."""

    def __init__(self, key_dim: int, num_heads: int, d_model: int, attention_impl: str = "dense",
                 dropout_rate: float = 0.1, ffn_impl: str = "dense", num_experts: int = 4,
                 moe_capacity_factor: float = 2.0, moe_ff_dim: Optional[int] = None):
        super().__init__()
        if ffn_impl not in FFN_IMPLS:
            raise ValueError(f"ffn_impl must be one of {FFN_IMPLS}, got {ffn_impl!r}")
        self.dropout_rate = dropout_rate
        self.d_model = d_model
        self.norm_1 = nn.LayerNorm(d_model, eps=1e-6)
        self.attn = TFMultiHeadAttention(num_heads, key_dim, d_model, attention_impl, dropout_rate)
        self.norm_2 = nn.LayerNorm(d_model, eps=1e-6)
        if ffn_impl == "moe":
            self.moe = MoEFeedForward(d_model, num_experts, moe_ff_dim, moe_capacity_factor)
        else:
            self.ff = QuantLinear(d_model, d_model)

    def _ffn(self, y: torch.Tensor, per_row: bool):
        if hasattr(self, "moe"):
            return self.moe(y, per_row)
        return tp.column_parallel(self.ff, y, self.d_model), None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, rngs: Rngs = None, per_row: bool = False):
        x = x + self.attn(self.norm_1(x), mask, train, rngs)
        y, aux = self._ffn(self.norm_2(x), per_row)
        return x + dropout(y, self.dropout_rate, train, rngs), aux

    def decode(self, x, mask, kv_cache, cache_index, per_row: bool = False):
        """The block over new positions against the layer's (b, 2, cache_len,
        h, key_dim) cache; returns (x, updated cache)."""
        y, kv_cache = self.attn.decode(self.norm_1(x), mask, kv_cache, cache_index)
        x = x + y
        y, _ = self._ffn(self.norm_2(x), per_row)
        return x + y, kv_cache


class CausalTransformer(nn.Module):
    """Token-in, vocab-logits-out decoder. `remat=True` recomputes each
    layer in the backward pass (`ops/remat.py`), as JAX's `nn.remat` of
    the block does."""

    def __init__(self, input_emb: int, num_layers: int = 8, key_dim: int = 128,
                 num_heads: int = 8, d_model: int = 512, vocab_size: int = 256,
                 max_seq_len: int = 256, attention_impl: str = "dense",
                 dropout_rate: float = 0.1, ffn_impl: str = "dense", num_experts: int = 4,
                 moe_capacity_factor: float = 2.0, moe_ff_dim: Optional[int] = None,
                 remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.max_seq_len = max_seq_len
        self.remat = remat
        self.d_model = d_model
        self.vocab_size = vocab_size
        self.attention_impl = normalize_attention_impl(attention_impl)
        self.ffn_impl = ffn_impl
        self.dropout_rate = dropout_rate
        # The pipeline's stage plan (`parallel/pipeline.py::StagePlan`),
        # set by the partition of a grid with a `stage` axis.
        self.stages = None
        self.token_emb = nn.Linear(input_emb, d_model)
        self.position_emb = nn.Embedding(max_seq_len, d_model)
        for i in range(num_layers):
            self.add_module(
                f"layer_{i}",
                TransformerLayer(key_dim, num_heads, d_model, attention_impl, dropout_rate,
                                 ffn_impl, num_experts, moe_capacity_factor, moe_ff_dim),
            )
        self.output_tokens = nn.Linear(d_model, vocab_size)

    def forward(self, inputs: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                train: bool = False, rngs: Rngs = None, per_row: bool = False,
                return_aux: bool = False):
        """inputs: (b, s, input_emb) -> logits (b, s, vocab_size); with
        `return_aux`, (logits, the MoE layers' aux losses in layer order)."""
        b, s, _ = inputs.shape
        if s > self.max_seq_len:
            raise ValueError(f"sequence length {s} exceeds max_seq_len={self.max_seq_len}")
        if self.stages is not None:
            from rt1_tpu_torch.parallel.pipeline import pp_causal_transformer_apply

            logits = pp_causal_transformer_apply(self, inputs, attention_mask, train, rngs)
            return (logits, []) if return_aux else logits
        x = self.embed(inputs)
        aux_losses = []
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if self.remat and train:
                x, aux = checkpoint(layer, x, attention_mask, train, rngs, per_row, rngs=rngs)
            else:
                x, aux = layer(x, attention_mask, train, rngs, per_row)
            if aux is not None:
                aux_losses.append(aux)
        logits = self.head(x)
        return (logits, aux_losses) if return_aux else logits

    def embed(self, inputs: torch.Tensor) -> torch.Tensor:
        """(b, s, input_emb) -> (b, s, d_model): the token embedding
        (column-parallel under tp) plus the position rows."""
        x = tp.column_parallel(self.token_emb, inputs.to(self.token_emb.weight.dtype),
                               self.d_model)
        return x + self.position_emb.weight[:inputs.shape[1]][None]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """(b, s, d_model) -> logits (b, s, vocab_size), column-parallel
        under tp."""
        return tp.column_parallel(self.output_tokens, x, self.vocab_size)

    def decode(self, inputs: torch.Tensor, attention_mask: torch.Tensor, kv_cache: torch.Tensor,
               cache_index: torch.Tensor, per_row: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """inputs: (b, s, input_emb), the new positions of each row, embedded
        at `cache_index + arange(s)`; attention_mask: (s, cache_len) or (b, s,
        cache_len); kv_cache: (b, layers, 2, cache_len, heads, key_dim);
        cache_index: (b,). Returns (logits (b, s, vocab), updated cache).
        The whole sequence with `cache_index` 0 and the square mask
        recomputes every cache row (the engine's rebuild). A MoE FFN routes
        the new positions only, so its capacity binds over them, as in
        JAX's cached step."""
        b, s, _ = inputs.shape
        if s > self.max_seq_len:
            raise ValueError(f"sequence length {s} exceeds max_seq_len={self.max_seq_len}")
        x = self.token_emb(inputs.to(self.token_emb.weight.dtype))
        positions = cache_index.to(torch.long)[:, None] + torch.arange(s, device=x.device)
        x = x + self.position_emb.weight[positions]
        caches = []
        for i in range(self.num_layers):
            x, layer_cache = getattr(self, f"layer_{i}").decode(
                x, attention_mask, kv_cache[:, i], cache_index, per_row)
            caches.append(layer_cache)
        return self.output_tokens(x), torch.stack(caches, dim=1)
