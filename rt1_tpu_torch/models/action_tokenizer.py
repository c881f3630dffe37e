"""Discretized action tokenizer (counterpart of
`rt1_tpu/models/action_tokenizer.py`).

* a `DiscreteSpec` action is one token, passed through as its own id; an id
  strictly greater than `n` decodes to 0 — the reference's `tok > n` quirk,
  kept so a policy emitting exactly `n` behaves the same in both packages;
* a rank-1 `BoxSpec` action is `shape[0]` tokens: encoded by clipping to
  [low, high], min-max normalising, scaling by `vocab_size - 1` and
  truncating to int32; decoded as `token / (vocab_size - 1) * (high - low)
  + low`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from rt1_tpu_torch.specs import BoxSpec, DiscreteSpec, Spec


def tokens_per_action(action_space: Mapping[str, Spec]) -> int:
    """Number of tokens one action maps to."""
    n = 0
    for key, spec in action_space.items():
        if isinstance(spec, DiscreteSpec):
            n += 1
        elif isinstance(spec, BoxSpec):
            if len(spec.shape) != 1:
                raise ValueError(
                    f"Only action shapes with single dimension supported, got {spec.shape}"
                )
            n += spec.shape[0]
        else:
            raise ValueError(
                f"action space entries must be Discrete or Box, got {spec!r} for {key!r}"
            )
    return n


def tokenize(
    action_space: Mapping[str, Spec],
    action: Mapping[str, torch.Tensor],
    vocab_size: int,
) -> torch.Tensor:
    """Action dict -> int32 tokens (..., tokens_per_action)."""
    parts = []
    for key, spec in action_space.items():
        a = action[key]
        if isinstance(spec, DiscreteSpec):
            parts.append(a.to(torch.int32)[..., None])
        elif isinstance(spec, BoxSpec):
            low = torch.tensor(spec.low_array(), device=a.device)
            high = torch.tensor(spec.high_array(), device=a.device)
            t = (torch.clamp(a.to(torch.float32), low, high) - low) / (high - low)
            # XLA converts a NaN to int 0 (a poisoned batch still tokenizes
            # and its loss goes NaN for the guard); torch's cast leaves it
            # undefined.
            t = torch.nan_to_num(t, nan=0.0)
            parts.append((t * (vocab_size - 1)).to(torch.int32))  # truncation
        else:
            raise ValueError(f"unsupported spec {spec!r}")
    return torch.cat(parts, dim=-1)


def continuous_targets(
    action_space: Mapping[str, Spec], action: Mapping[str, torch.Tensor]
) -> torch.Tensor:
    """Clipped continuous action values laid out per token (..., A): zeros
    in Discrete slots, the clipped Box values in Box slots — the targets of
    the soft-argmax auxiliary."""
    parts = []
    for key, spec in action_space.items():
        a = action[key]
        if isinstance(spec, DiscreteSpec):
            parts.append(torch.zeros(a.shape + (1,), dtype=torch.float32, device=a.device))
        elif isinstance(spec, BoxSpec):
            low = torch.tensor(spec.low_array(), device=a.device)
            high = torch.tensor(spec.high_array(), device=a.device)
            parts.append(torch.clamp(a.to(torch.float32), low, high))
        else:
            raise ValueError(f"unsupported spec {spec!r}")
    return torch.cat(parts, dim=-1)


def detokenize(
    action_space: Mapping[str, Spec],
    action_tokens: torch.Tensor,
    vocab_size: int,
) -> Dict[str, torch.Tensor]:
    """Tokens (..., tokens_per_action) -> action dict."""
    action: Dict[str, torch.Tensor] = {}
    idx = 0
    for key, spec in action_space.items():
        if isinstance(spec, DiscreteSpec):
            tok = action_tokens[..., idx]
            action[key] = torch.where(tok > spec.n, torch.zeros_like(tok), tok)
            idx += 1
        elif isinstance(spec, BoxSpec):
            dim = spec.shape[0]
            tok = action_tokens[..., idx : idx + dim].to(torch.float32)
            low = torch.tensor(spec.low_array(), device=tok.device)
            high = torch.tensor(spec.high_array(), device=tok.device)
            action[key] = tok / (vocab_size - 1) * (high - low) + low
            idx += dim
        else:
            raise ValueError(f"unsupported spec {spec!r}")
    return action


def box_bin_values(
    action_space: Mapping[str, Spec], vocab_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token bin values `(tokens_per_action, vocab_size)` and the Box
    mask `(tokens_per_action,)`: `values[k, v]` is the action `detokenize`
    maps token `v` of Box token `k` to; Discrete rows are zero and masked."""
    if vocab_size < 2:
        raise ValueError(f"vocab_size must be >= 2, got {vocab_size}")
    if not any(isinstance(s, BoxSpec) for s in action_space.values()):
        raise ValueError(
            "soft-argmax regression needs at least one Box action entry; "
            "this action space is all-Discrete"
        )
    rows = []
    mask = []
    grid = np.arange(vocab_size, dtype=np.float32) / float(vocab_size - 1)
    for spec in action_space.values():
        if isinstance(spec, DiscreteSpec):
            rows.append(np.zeros((1, vocab_size), np.float32))
            mask.append(np.zeros((1,), np.float32))
        elif isinstance(spec, BoxSpec):
            low = np.asarray(spec.low_array(), np.float32)
            high = np.asarray(spec.high_array(), np.float32)
            rows.append(grid[None, :] * (high - low)[:, None] + low[:, None])
            mask.append(np.ones((spec.shape[0],), np.float32))
        else:
            raise ValueError(f"unsupported spec {spec!r}")
    return np.concatenate(rows, 0), np.concatenate(mask, 0)


def detokenize_expected(
    action_space: Mapping[str, Spec],
    logits: torch.Tensor,
    vocab_size: int,
) -> Dict[str, torch.Tensor]:
    """Soft decode: Box entries are E[a] under the token softmax; Discrete
    entries decode by argmax with the `tok > n` quirk."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    values, _ = box_bin_values(action_space, vocab_size)
    values = torch.tensor(values, device=logits.device)
    expected = torch.einsum("...av,av->...a", probs, values)
    action: Dict[str, torch.Tensor] = {}
    idx = 0
    for key, spec in action_space.items():
        if isinstance(spec, DiscreteSpec):
            tok = torch.argmax(logits[..., idx, :], dim=-1).to(torch.int32)
            action[key] = torch.where(tok > spec.n, torch.zeros_like(tok), tok)
            idx += 1
        elif isinstance(spec, BoxSpec):
            dim = spec.shape[0]
            action[key] = expected[..., idx : idx + dim]
            idx += dim
        else:
            raise ValueError(f"unsupported spec {spec!r}")
    return action
