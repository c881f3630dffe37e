"""Canned-episode parity gates for low-precision and KV-cached engines (a
copy of `rt1_tpu/serve/parity.py`).

Before a bf16/int8 engine is trusted, its action-token stream is compared
with the f32 engine's on canned, seeded episodes: action tokens are what
the robot executes and what the rolling window stores. `check_parity`
raises below `PARITY_THRESHOLD`. `check_cached_parity` gates a KV-cached
engine against the windowed one while windows fill (cached decode is
exact there) and reports the post-roll steady-state agreement, which it
does not gate. The engines only need `reset`, `act`, `release` and (the
cached one) `window`, so an engine of either package can stand on either
side.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

# The floor for low-precision and cached token agreement: below it,
# quantization noise is flipping decoded actions and the engine must not
# serve.
PARITY_THRESHOLD = 0.99


def canned_episodes(
    image_shape: Sequence[int],
    embed_dim: int = 512,
    episodes: int = 4,
    steps: int = 8,
    seed: int = 1234,
) -> List[List[Dict[str, np.ndarray]]]:
    """Deterministic synthetic episodes: `episodes` lists of `steps`
    observations, one fixed instruction embedding per episode (matching a
    real session's constant instruction across its rolling window)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(episodes):
        embedding = rng.standard_normal(embed_dim).astype(np.float32)
        out.append(
            [
                {
                    "image": rng.random(tuple(image_shape)).astype(
                        np.float32
                    ),
                    "natural_language_embedding": embedding,
                }
                for _ in range(steps)
            ]
        )
    return out


def action_token_agreement(
    engine_ref: Any,
    engine_test: Any,
    episodes: Sequence[Sequence[Dict[str, np.ndarray]]],
    skip_steps: int = 0,
) -> Dict[str, Any]:
    """Step both engines through the same observation streams and compare
    action tokens elementwise.

    Returns agreement statistics (``agreement`` in [0, 1], plus the max
    absolute de-normalized action delta — the physical-units view of the
    same divergence). Each engine advances its own rolling state from its
    own weights; tokens are compared per step, so a divergence that
    compounds through the window is charged to every later step it
    corrupts, not amortized away.

    ``skip_steps`` excludes each episode's first N steps from the
    statistics while still stepping both engines through them — used by
    the KV-cache gate to measure the post-roll-over steady state in
    isolation from the (exact) window-fill phase.
    """
    total = 0
    agree = 0
    steps = 0
    max_action_diff = 0.0
    for index, episode in enumerate(episodes):
        sid = f"parity-{index}"
        engine_ref.reset(sid)
        engine_test.reset(sid)
        for step_index, obs in enumerate(episode):
            ref = engine_ref.act(sid, dict(obs))
            test = engine_test.act(sid, dict(obs))
            if step_index < skip_steps:
                continue
            ref_tokens = np.asarray(ref["action_tokens"])
            test_tokens = np.asarray(test["action_tokens"])
            total += int(ref_tokens.size)
            agree += int((ref_tokens == test_tokens).sum())
            max_action_diff = max(
                max_action_diff,
                float(
                    np.max(np.abs(ref["action"] - test["action"]))
                ),
            )
            steps += 1
        engine_ref.release(sid)
        engine_test.release(sid)
    return {
        "episodes": len(episodes),
        "steps": steps,
        "tokens_total": total,
        "tokens_agree": agree,
        "agreement": (agree / total) if total else 1.0,
        "max_abs_action_diff": max_action_diff,
    }


def check_parity(
    engine_ref: Any,
    engine_test: Any,
    image_shape: Sequence[int],
    threshold: float = PARITY_THRESHOLD,
    **episode_kwargs: Any,
) -> Dict[str, Any]:
    """Run the gate; raise ValueError (with the stats in the message) when
    agreement lands below `threshold`. Returns the stats dict on pass."""
    stats = action_token_agreement(
        engine_ref, engine_test, canned_episodes(image_shape, **episode_kwargs)
    )
    stats["threshold"] = threshold
    stats["passed"] = stats["agreement"] >= threshold
    if not stats["passed"]:
        raise ValueError(
            f"low-precision parity gate FAILED: action-token agreement "
            f"{stats['agreement']:.4f} < {threshold} over "
            f"{stats['tokens_total']} tokens "
            f"(max action delta {stats['max_abs_action_diff']:.5f}) — "
            "refusing to trust this engine"
        )
    return stats


def check_cached_parity(
    engine_ref: Any,
    engine_cached: Any,
    image_shape: Sequence[int],
    threshold: float = PARITY_THRESHOLD,
    steady_steps: int = 5,
    **episode_kwargs: Any,
) -> Dict[str, Any]:
    """Gate a KV-cached engine against the windowed reference engine.

    The incremental-decode contract has two regimes and the gate measures
    both:

    * **Fill** (the enforced gate): while a session's window fills — and
      after any cache rebuild — cached decode attends the same keys at
      the same positions as the full-window pass, so tokens must agree
      at >= `threshold` (they are bit-exact in practice; causal attention
      means earlier tokens never depend on later ones). Below threshold
      the cache plumbing is wrong and this raises ValueError.
    * **Steady state** (the reported statistic): after roll-over, cache
      entries keep their insertion-time learned position embeddings and
      pre-roll context, so agreement with the windowed engine is
      approximate (staleness structurally bounded at window-1 rolls —
      entries leave the window after `time_sequence_length` rolls).
      Reported as ``steady_agreement`` for deployment A/Bs, not gated:
      it measures an accepted accuracy/latency trade, not a bug.

    Episodes for the fill gate are cut at the window length so no roll
    occurs; the steady-state measurement then runs `window + steady_steps`
    steps and skips the fill prefix.
    """
    window = int(engine_cached.window)
    fill_kwargs = dict(episode_kwargs)
    fill_kwargs["steps"] = window
    stats = action_token_agreement(
        engine_ref,
        engine_cached,
        canned_episodes(image_shape, **fill_kwargs),
    )
    stats["threshold"] = threshold
    stats["passed"] = stats["agreement"] >= threshold
    steady_kwargs = dict(episode_kwargs)
    steady_kwargs["steps"] = window + steady_steps
    steady = action_token_agreement(
        engine_ref,
        engine_cached,
        canned_episodes(image_shape, **steady_kwargs),
        skip_steps=window,
    )
    stats["steady_agreement"] = steady["agreement"]
    stats["steady_steps"] = steady["steps"]
    stats["steady_max_abs_action_diff"] = steady["max_abs_action_diff"]
    if not stats["passed"]:
        raise ValueError(
            f"cached-inference parity gate FAILED: fill-phase action-token "
            f"agreement {stats['agreement']:.4f} < {threshold} over "
            f"{stats['tokens_total']} tokens — cached decode must be exact "
            "while the window fills; refusing to trust this engine"
        )
    return stats
