"""The real promotion gate: eval matrix + serve parity, on the card.

The port's copy of `rt1_tpu/deploy/gate.py` (the port imports nothing of
the JAX package). It composes the two offline judgements into one verdict
payload for the controller:

* **eval-matrix gate** (`eval/matrix.run_gate`): closed-loop success of
  the candidate checkpoint vs. the incumbent on the same task grid,
  lazy per-column restore — one parameter set resident at a time. The
  policies run the fused attention kernel on `device`.
* **parity gate** (`serve/parity.check_parity`): the candidate restored
  into a serving engine at the fleet's inference dtype must agree with
  its float32 reference engine on ≥99% of action tokens over the canned
  episode set — the same bar a quantized replica must clear before it
  serves. Catches a checkpoint that evals fine but serves badly BEFORE it
  touches a live replica. The reference computes in float32 whatever the
  config's compute dtype, so on the card its attention runs the 3xTF32
  kernel and the serving engine's the bf16 tensor-core kernel.

Both engines are built for the verdict and dropped after it, so the fleet
process holds one gate's weights at a time. The verdict carries the
gate's timings (matrix, engine builds, parity check), the attention
launches it made per kernel variant and, on the card, the process's peak
device memory.

Everything heavy imports lazily inside the functions: the module itself
imports in the torch-free controller process; only *calling* the gate
pays the torch import. The stub fleet path injects an auto-pass `gate_fn`
instead and never imports this module's internals.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence


def load_config(name: str):
    """The port's config `name` (language_table | tiny, or the path of the
    JAX config file of that name): the config the replicas were launched
    with, so ``--promote_from`` binds the real gate to it."""
    from rt1_tpu_torch.configs import get_config

    return get_config(name)


def _launch_counts() -> Dict[str, int]:
    from rt1_tpu_torch.parallel.flash_attention import fused_attention

    return dict(fused_attention.launches_by_variant)


def _launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    after = _launch_counts()
    return {k: after[k] - before.get(k, 0) for k in after}


def run_parity_gate(
    config,
    workdir: str,
    step: int,
    *,
    inference_dtype: str = "f32",
    threshold: Optional[float] = None,
    episodes: int = 2,
    steps: int = 4,
    device=None,
) -> Dict[str, Any]:
    """Restore `step` twice — float32 reference + serving dtype — and run
    the action-token parity check on `device`. Returns the stats dict; a
    failed gate returns ``passed: False`` (the ValueError is caught and
    folded in) so the controller records a rejection instead of crashing
    the loop."""
    import torch

    from rt1_tpu_torch.eval.restore import build_serve_engine, config_with_model_dtype
    from rt1_tpu_torch.serve import parity

    t0 = time.perf_counter()
    engine_ref, _ = build_serve_engine(
        config_with_model_dtype(config, "float32"), workdir=workdir, step=step,
        inference_dtype="f32", device=device, attention_impl="fused",
    )
    engine_test, _ = build_serve_engine(
        config, workdir=workdir, step=step, inference_dtype=inference_dtype,
        device=device, attention_impl="fused",
    )
    build_s = time.perf_counter() - t0
    shape = (config.data.height, config.data.width, 3)
    kwargs: Dict[str, Any] = {"episodes": episodes, "steps": steps}
    if threshold is not None:
        kwargs["threshold"] = threshold
    t1 = time.perf_counter()
    try:
        stats = parity.check_parity(
            engine_ref, engine_test, shape, **kwargs
        )
    except ValueError as exc:
        stats = {"passed": False, "error": str(exc)}
    stats["inference_dtype"] = inference_dtype
    stats["reference_steps"] = engine_ref.steps_total
    stats["build_seconds"] = round(build_s, 3)
    stats["check_seconds"] = round(time.perf_counter() - t1, 3)
    del engine_ref, engine_test
    if torch.cuda.is_available():
        torch.cuda.empty_cache()  # give the freed weights back to the replicas
    return stats


def build_gate_fn(
    config,
    workdir: str,
    *,
    tasks: Optional[Sequence[str]] = None,
    episodes_per_cell: int = 2,
    max_episode_steps: int = 80,
    block_mode: str = "BLOCK_8",
    seed: int = 0,
    embedder: str = "hash",
    env_kwargs: Optional[Dict[str, Any]] = None,
    margin: float = 0.0,
    inference_dtype: str = "f32",
    parity_episodes: int = 2,
    parity_steps: int = 4,
    progress: Optional[Callable[[str, str, Dict[str, Any]], None]] = None,
    device=None,
) -> Callable[[int, Optional[int]], Dict[str, Any]]:
    """Bind config + gate knobs into the ``gate_fn(candidate_step,
    incumbent_step) -> verdict`` the PromotionController consumes.

    The verdict passes only when BOTH judgements pass; the eval matrix
    runs first (cheaper rejection: a regressed policy never pays the
    double engine build the parity check needs)."""
    from rt1_tpu_torch.eval import matrix as matrix_lib

    def gate_fn(
        candidate_step: int, incumbent_step: Optional[int]
    ) -> Dict[str, Any]:
        import torch

        t0 = time.perf_counter()
        before = _launch_counts()
        verdict = matrix_lib.run_gate(
            config,
            workdir,
            candidate_step,
            incumbent_step,
            tasks=tasks,
            episodes_per_cell=episodes_per_cell,
            max_episode_steps=max_episode_steps,
            block_mode=block_mode,
            seed=seed,
            embedder=embedder,
            env_kwargs=env_kwargs,
            margin=margin,
            progress=progress,
            device=device,
        )
        verdict["matrix_attention_launches"] = _launch_delta(before)
        verdict["matrix_seconds"] = round(time.perf_counter() - t0, 3)
        eval_passed = bool(verdict["passed"])
        if eval_passed:
            before = _launch_counts()
            parity = run_parity_gate(
                config,
                workdir,
                candidate_step,
                inference_dtype=inference_dtype,
                episodes=parity_episodes,
                steps=parity_steps,
                device=device,
            )
            parity["attention_launches"] = _launch_delta(before)
            verdict["parity"] = parity
            verdict["passed"] = bool(parity.get("passed"))
        else:
            verdict["parity"] = {"skipped": "eval gate failed"}
        verdict["eval_passed"] = eval_passed
        verdict["gate_seconds"] = round(time.perf_counter() - t0, 3)
        if torch.cuda.is_available():
            verdict["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
        return verdict

    return gate_fn
