"""RT-1 policy network, train and inference paths (counterpart of
`rt1_tpu/models/rt1.py`).

`forward(observations, actions, train)` is the training forward of the
JAX module's `__call__`: ONE transformer pass over the T*(I+A) sequence,
action-token CE on the logits one position before each action token,
scaled as the reference does (`/(b*t*(I+A))`, the JAX module's
`loss_scale="reference"`), optionally focal-modulated and with the
soft-argmax MSE auxiliary. Train mode crops (`crop_ratio`, from `rngs["crop"]`), jitters
colour with `photometric_augmentation` (`rngs["augment"]`), drops out
(`rngs["dropout"]`), applies stochastic depth
(`rngs["stochastic_depth"]`) and uses BatchNorm's batch statistics; the
generators are passed in, never drawn from the global one.

The policy keeps a rolling window per stream — context image tokens,
action tokens and `seq_idx` — and reads all action tokens of a control
step from ONE transformer pass (action inputs are zeroed and masked, so
the reference's per-token passes are identical).

Unlike the JAX module, whose `seq_idx` is one scalar for the whole batch
(the JAX serving engine vmaps a batch-1 step to give each stream its own),
the port steps a batch of streams at different phases at once: `seq_idx`
is a `(b,)` tensor, and the roll, the insert, the step-logit gather and
the action write all act per row. A batch whose rows share a phase is
exactly the JAX computation.

`infer_step_cached` is the incremental step against a per-stream K/V
cache (`initial_state(b, cached=True)`): it runs the transformer over the
new frame's I+A positions only, attending the cached prefix. While a
window fills it equals `infer_step` to float tolerance; once full, the
cache rolls by one step block and the surviving rows keep the K/V they
were computed with (position rows and context one frame stale per roll),
as in JAX. `rebuild_cache` recomputes every row from the stored image
tokens (the engine runs it after a weight swap). The roll, the cache
write, the position rows and the decode-mask rows are per row.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rt1_tpu_torch.models import action_tokenizer
from rt1_tpu_torch.models.image_tokenizer import RT1ImageTokenizer
from rt1_tpu_torch.models.transformer import CausalTransformer
from rt1_tpu_torch.ops import augment
from rt1_tpu_torch.ops import image as image_ops
from rt1_tpu_torch.ops.dropout import Rngs


def rt1_attention_mask(
    time_sequence_length: int, tokens_per_image: int, tokens_per_action: int
) -> np.ndarray:
    """The RT-1 attention mask: (S, S) uint8, S = T*(I+A); 1 = may attend.

    Causal, minus an action mask: an action-token query never attends to
    action-token keys of the same or earlier timestep (itself included)."""
    step = tokens_per_image + tokens_per_action
    size = time_sequence_length * step

    def action_time(k: int) -> int:
        return k // step if (k % step) >= tokens_per_image else -1

    mask = np.tril(np.ones((size, size), np.uint8))
    for i in range(size):
        ti = action_time(i)
        if ti < 0:
            continue
        for j in range(i + 1):
            tj = action_time(j)
            if tj < 0:
                continue
            if tj < ti or (tj == ti and j <= i):
                mask[i, j] = 0
    return mask


def action_token_positions(
    time_sequence_length: int, tokens_per_image: int, tokens_per_action: int
) -> np.ndarray:
    """Sequence indices of the action tokens."""
    step = tokens_per_image + tokens_per_action
    return np.array(
        [
            t * step + tokens_per_image + x
            for t in range(time_sequence_length)
            for x in range(tokens_per_action)
        ],
        np.int32,
    )


def softmax_ce_int(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with integer labels: logsumexp(logits) - logits[label]."""
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, labels[..., None].to(torch.long))[..., 0]
    return logz - label_logits


class RT1Policy(nn.Module):
    """The RT-1 actor network."""

    def __init__(
        self,
        action_space: Mapping[str, Any],
        vocab_size: int = 256,
        token_embedding_size: int = 512,
        num_layers: int = 8,
        layer_size: int = 128,
        num_heads: int = 8,
        feed_forward_size: int = 512,
        time_sequence_length: int = 6,
        num_image_tokens: int = 8,
        image_tokenizer: Optional[nn.Module] = None,
        action_decode: str = "argmax",
        attention_impl: str = "dense",
        dropout_rate: float = 0.1,
        crop_ratio: float = 0.07,
        photometric_augmentation: bool = False,
        focal_gamma: float = 0.0,
        aux_mse_weight: float = 0.0,
        tokenizer_flax_name: Optional[str] = None,
        ffn_impl: str = "dense",
        num_experts: int = 4,
        moe_capacity_factor: float = 2.0,
        moe_ff_dim: Optional[int] = None,
        remat: bool = False,
    ):
        super().__init__()
        if action_decode not in ("argmax", "expected"):
            raise ValueError(f"action_decode must be 'argmax' or 'expected', got {action_decode!r}")
        self.crop_ratio = crop_ratio
        self.photometric_augmentation = photometric_augmentation
        self.photometric_config = augment.PhotometricConfig()  # the reference's ranges
        self.focal_gamma = focal_gamma
        self.aux_mse_weight = aux_mse_weight
        self.action_space = dict(action_space)
        self.vocab_size = vocab_size
        self.token_embedding_size = token_embedding_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.layer_size = layer_size
        self.time_sequence_length = time_sequence_length
        self.action_decode = action_decode
        self.tokens_per_image = num_image_tokens
        self.tokens_per_action = action_tokenizer.tokens_per_action(self.action_space)
        self.single_step_tokens = self.tokens_per_image + self.tokens_per_action
        self.sequence_tokens = time_sequence_length * self.single_step_tokens
        # The tokenizer's name in the JAX module's variables: its own
        # tokenizer is `image_tokenizer`, one passed in `image_tokenizer_def`.
        self.tokenizer_flax_name = tokenizer_flax_name or (
            "image_tokenizer" if image_tokenizer is None else "image_tokenizer_def")
        if image_tokenizer is None:
            image_tokenizer = RT1ImageTokenizer(
                embedding_output_dim=token_embedding_size, num_tokens=num_image_tokens
            )
        self.image_tokenizer = image_tokenizer
        self.transformer = CausalTransformer(
            input_emb=token_embedding_size,
            num_layers=num_layers,
            key_dim=layer_size,
            num_heads=num_heads,
            d_model=feed_forward_size,
            vocab_size=vocab_size,
            # Grown past 256 if the window needs it, as in the JAX module.
            max_seq_len=max(256, self.sequence_tokens),
            attention_impl=attention_impl,
            dropout_rate=dropout_rate,
            ffn_impl=ffn_impl,
            num_experts=num_experts,
            moe_capacity_factor=moe_capacity_factor,
            moe_ff_dim=moe_ff_dim,
            remat=remat,
        )
        self.ffn_impl = ffn_impl
        mask = rt1_attention_mask(
            time_sequence_length, self.tokens_per_image, self.tokens_per_action
        )
        self.register_buffer("attention_mask", torch.from_numpy(mask), persistent=False)
        # The transformer predicts the next token: each action token's logits
        # are read one position early.
        positions = action_token_positions(
            time_sequence_length, self.tokens_per_image, self.tokens_per_action
        )
        self.register_buffer("pred_positions", torch.from_numpy(positions - 1).to(torch.long),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.attention_mask.device

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the network computes in (its embedding's, never int8)."""
        return self.transformer.token_emb.weight.dtype

    def initial_state(self, batch_size: int, cached: bool = False) -> Dict[str, torch.Tensor]:
        """Zeroed rolling window: the JAX leaves' names, shapes and dtypes,
        except that `seq_idx` is per row, `(batch_size,)`. `cached=True` adds
        the `kv_cache` leaf, (b, layers, 2, sequence_tokens, heads, key_dim)
        at the compute dtype."""
        t = self.time_sequence_length
        dev = self.device
        state = {
            "context_image_tokens": torch.zeros(
                (batch_size, t, self.tokens_per_image, self.token_embedding_size),
                dtype=torch.float32, device=dev,
            ),
            "action_tokens": torch.zeros(
                (batch_size, t, self.tokens_per_action), dtype=torch.int32, device=dev
            ),
            "seq_idx": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        }
        if cached:
            state["kv_cache"] = torch.zeros(
                (batch_size, self.num_layers, 2, self.sequence_tokens, self.num_heads,
                 self.layer_size),
                dtype=self.compute_dtype, device=dev,
            )
        return state

    def _tokenize_images(self, image: torch.Tensor, context: Optional[torch.Tensor],
                         train: bool = False, rngs: Rngs = None) -> torch.Tensor:
        """image (b, t, H, W, 3), context (b, t, D) or (b, D) -> (b, t, I, E).
        Train mode crops (unless `crop_ratio` is 0) with `rngs["crop"]`,
        then, with `photometric_augmentation`, jitters colour with one level
        per call from `rngs["augment"]` (else `rngs["crop"]`)."""
        if context is not None and context.dim() == 2:
            context = context[:, None, :].expand(-1, image.shape[1], -1)
        rngs = rngs or {}
        do_crop = train and self.crop_ratio > 0
        image = image_ops.convert_dtype_and_crop_images(
            image, generator=rngs.get("crop"), ratio=self.crop_ratio, train=do_crop)
        if train and self.photometric_augmentation:
            generator = rngs.get("augment", rngs.get("crop"))
            if generator is None:
                raise ValueError("photometric augmentation needs rngs['augment'] or rngs['crop']")
            image = augment.photometric_distortions(image, generator, self.photometric_config)
        return self.image_tokenizer(image, context=context, train=train, rngs=rngs)

    def _assemble(self, context_image_tokens: torch.Tensor) -> torch.Tensor:
        """(b, t, I, E) -> (b, t*(I+A), E) with zeroed action slots."""
        b, t, _, e = context_image_tokens.shape
        slots = context_image_tokens.new_zeros((b, t, self.tokens_per_action, e))
        seq = torch.cat([context_image_tokens, slots], dim=2)
        return seq.reshape(b, t * self.single_step_tokens, e)

    def forward(
        self,
        observations: Dict[str, torch.Tensor],
        actions: Dict[str, torch.Tensor],
        train: bool = False,
        rngs: Rngs = None,
    ) -> Dict[str, torch.Tensor]:
        """Training forward. observations: {'image': (b, t, H, W, 3),
        'natural_language_embedding': (b, t, D) or (b, D)}; actions: per-key
        (b, t, ...) labels. Returns the JAX aux dict: loss (scalar),
        action_loss (b, t), cross_entropy (b, t, A), action_labels (b, t, A),
        action_logits (b, t, A, vocab) and action_predictions (b, t, A), plus
        aux_mse when `aux_mse_weight > 0` and, with the MoE FFN,
        moe_aux_loss: the mean over layers of their load-balancing losses
        (the trainer adds it to the train loss; "loss" stays the task
        loss, as JAX's model output does)."""
        image = observations["image"]
        context = observations.get("natural_language_embedding")
        b, t = image.shape[0], image.shape[1]
        if t != self.time_sequence_length:
            raise ValueError(f"window {t} != time_sequence_length {self.time_sequence_length}")
        context_image_tokens = self._tokenize_images(image, context, train, rngs)
        logits, aux_losses = self.transformer(self._assemble(context_image_tokens),
                                              attention_mask=self.attention_mask, train=train,
                                              rngs=rngs, return_aux=True)
        labels = action_tokenizer.tokenize(self.action_space, actions, self.vocab_size)
        action_logits = logits.index_select(1, self.pred_positions).reshape(
            b, t, self.tokens_per_action, self.vocab_size)
        ce = softmax_ce_int(action_logits.float(), labels)  # (b, t, A)
        loss_terms = ce
        if self.focal_gamma > 0:
            # 1 - p_label = -expm1(-ce); the floor keeps a fractional power
            # differentiable where ce reaches 0. "cross_entropy" stays raw.
            base = torch.clamp(-torch.expm1(-ce), min=1e-12)
            loss_terms = base ** self.focal_gamma * ce
        num_items = float(b * t) * self.single_step_tokens
        action_loss = loss_terms.mean(dim=-1) / num_items
        loss = action_loss.mean()
        out = {
            "loss": loss,
            "action_loss": action_loss,
            "cross_entropy": ce,
            "action_labels": labels,
            "action_logits": action_logits,
            "action_predictions": torch.argmax(action_logits, dim=-1).to(torch.int32),
        }
        if self.aux_mse_weight > 0:
            bins, box_mask = action_tokenizer.box_bin_values(self.action_space, self.vocab_size)
            probs = torch.softmax(action_logits.float(), dim=-1)
            expected = torch.einsum("btav,av->bta", probs,
                                    torch.from_numpy(bins).to(probs.device))
            target = action_tokenizer.continuous_targets(self.action_space, actions)
            mask = torch.from_numpy(box_mask).to(probs.device)
            mse = torch.sum(torch.square(expected - target) * mask) / (float(box_mask.sum()) * b * t)
            # The aux term gets the CE's normaliser, so the whole loss stays
            # inversely proportional to the batch (gradient accumulation
            # relies on it); "aux_mse" stays raw.
            out["loss"] = loss + self.aux_mse_weight * mse / num_items
            out["aux_mse"] = mse
        if aux_losses:
            out["moe_aux_loss"] = torch.stack(aux_losses).mean()
        return out

    def _advance_window(self, observation, state):
        """Roll full windows, tokenize the new frame, insert it per row."""
        seq_idx = state["seq_idx"].to(torch.long)
        t_max = self.time_sequence_length
        time_step = torch.clamp(seq_idx, max=t_max - 1)
        full = seq_idx == t_max
        img_state = state["context_image_tokens"]
        act_state = state["action_tokens"]
        img_state = torch.where(full[:, None, None, None], img_state.roll(-1, dims=1), img_state)
        act_state = torch.where(full[:, None, None], act_state.roll(-1, dims=1), act_state)
        image = observation["image"][:, None]  # (b, 1, H, W, 3)
        context = observation.get("natural_language_embedding")
        new_tokens = self._tokenize_images(image, context)  # (b, 1, I, E)
        rows = torch.arange(img_state.shape[0], device=img_state.device)
        img_state = img_state.index_put((rows, time_step), new_tokens[:, 0].to(img_state.dtype))
        return img_state, act_state, time_step, seq_idx

    def infer_step(
        self, observation: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
        per_row: bool = False,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """One control step for a batch of streams, each at its own phase.

        observation: {'image': (b, H, W, 3), 'natural_language_embedding': (b, D)}.
        Returns ({'action_tokens', 'action_logits', <detokenized action>},
        new_state). `per_row` routes a MoE FFN per row (capacity over one
        stream's tokens: the JAX engine's vmapped batch-1 step), else over
        the whole batch (a direct JAX `infer_step`)."""
        img_state, act_state, time_step, seq_idx = self._advance_window(observation, state)
        logits = self.transformer(self._assemble(img_state), attention_mask=self.attention_mask,
                                  per_row=per_row)
        start = time_step * self.single_step_tokens + self.tokens_per_image - 1  # (b,)
        index = start[:, None] + torch.arange(self.tokens_per_action, device=start.device)
        step_logits = torch.gather(
            logits, 1, index[:, :, None].expand(-1, -1, logits.shape[-1])
        )  # (b, A, vocab)
        tokens = torch.argmax(step_logits, dim=-1).to(torch.int32)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        act_state = act_state.index_put((rows, time_step), tokens)
        new_state = {
            "context_image_tokens": img_state,
            "action_tokens": act_state,
            "seq_idx": torch.clamp(seq_idx + 1, max=self.time_sequence_length).to(torch.int32),
        }
        output = {"action_tokens": tokens, "action_logits": step_logits}
        output.update(self._decode_action(tokens, step_logits))
        return output, new_state

    def infer_step_cached(
        self, observation: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
        per_row: bool = False,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """`infer_step` against the `kv_cache` state leaf: the transformer
        runs over the new frame's step block only (see the module
        docstring). Same observation, state, output and `per_row` contract;
        a MoE FFN's capacity binds over the new block's positions."""
        step = self.single_step_tokens
        full = state["seq_idx"] == self.time_sequence_length
        kv = state["kv_cache"]
        kv = torch.where(full.view(-1, 1, 1, 1, 1, 1), kv.roll(-step, dims=3), kv)
        img_state, act_state, time_step, seq_idx = self._advance_window(observation, state)
        b = img_state.shape[0]
        rows = torch.arange(b, device=img_state.device)
        # The new frame's block: its image tokens and zeroed action slots,
        # float32 as in the stored window.
        frame = img_state[rows, time_step]  # (b, I, E)
        block = torch.cat([frame, frame.new_zeros((b, self.tokens_per_action, frame.shape[-1]))],
                          dim=1)
        q_start = time_step * step  # (b,)
        block_rows = q_start[:, None] + torch.arange(step, device=q_start.device)
        dec_mask = self.attention_mask[block_rows]  # (b, I+A, S)
        logits, new_kv = self.transformer.decode(block, dec_mask, kv, q_start, per_row)
        i0 = self.tokens_per_image - 1
        step_logits = logits[:, i0:i0 + self.tokens_per_action]  # (b, A, vocab)
        tokens = torch.argmax(step_logits, dim=-1).to(torch.int32)
        act_state = act_state.index_put((rows, time_step), tokens)
        new_state = {
            "context_image_tokens": img_state,
            "action_tokens": act_state,
            "seq_idx": torch.clamp(seq_idx + 1, max=self.time_sequence_length).to(torch.int32),
            "kv_cache": new_kv,
        }
        output = {"action_tokens": tokens, "action_logits": step_logits}
        output.update(self._decode_action(tokens, step_logits))
        return output, new_state

    def rebuild_cache(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every K/V cache row recomputed from the stored image tokens: one
        full-window pass, the math of `infer_step`'s (dense, not the kernel);
        a MoE FFN routes each stream's window on its own (`per_row`), as the
        JAX engine's rebuild does, vmapped over batch-1 states."""
        kv = state["kv_cache"]
        start = torch.zeros((kv.shape[0],), dtype=torch.long, device=kv.device)
        _, new_kv = self.transformer.decode(self._assemble(state["context_image_tokens"]),
                                            self.attention_mask, torch.zeros_like(kv), start,
                                            per_row=True)
        return dict(state, kv_cache=new_kv)

    def infer_step_autoregressive(
        self, observation: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor]
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The reference's token-by-token loop: A full transformer passes,
        each reading one action position. Equals `infer_step` (action inputs
        are zeroed); kept for that proof and for comparison."""
        img_state, act_state, time_step, seq_idx = self._advance_window(observation, state)
        start = time_step * self.single_step_tokens + self.tokens_per_image - 1  # (b,)
        rows = torch.arange(img_state.shape[0], device=img_state.device)
        toks, slices = [], []
        for k in range(self.tokens_per_action):
            logits = self.transformer(self._assemble(img_state), attention_mask=self.attention_mask)
            sl = logits[rows, start + k]  # (b, vocab)
            tok = torch.argmax(sl, dim=-1).to(torch.int32)
            act_state = act_state.index_put((rows, time_step, torch.full_like(rows, k)), tok)
            toks.append(tok)
            slices.append(sl)
        tokens = torch.stack(toks, dim=1)
        step_logits = torch.stack(slices, dim=1)
        new_state = {
            "context_image_tokens": img_state,
            "action_tokens": act_state,
            "seq_idx": torch.clamp(seq_idx + 1, max=self.time_sequence_length).to(torch.int32),
        }
        output = {"action_tokens": tokens, "action_logits": step_logits}
        output.update(self._decode_action(tokens, step_logits))
        return output, new_state

    def _decode_action(self, tokens, step_logits):
        if self.action_decode == "expected":
            return action_tokenizer.detokenize_expected(
                self.action_space, step_logits, self.vocab_size
            )
        return action_tokenizer.detokenize(self.action_space, tokens, self.vocab_size)
