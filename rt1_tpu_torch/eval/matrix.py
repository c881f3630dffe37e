"""Standing task × checkpoint eval matrix — the quality observability plane.

The port's copy of `rt1_tpu/eval/matrix.py` (the port imports nothing of
the JAX package); it keeps the JAX module's names, gauges and record, and
restores the port trainer's checkpoints, of either family (RT-1 or LAVA).

The fleet's observability (request tracing, SLOs, health packs) can see
*how fast* and *how healthy* the system is, but nothing answered *which
tasks* a policy actually performs: the repo ships nine reward families
(`envs/rewards/`) while closed-loop eval historically exercised one. This
module runs the closed-loop protocol (`eval/evaluate.py`) across a grid of
reward families × checkpoints and reports it three ways:

* **live Prometheus gauges during the sweep** — ``rt1_eval_success{task=,
  checkpoint=}`` (cell success rate so far) and ``rt1_eval_episodes_total
  {task=,checkpoint=}``, rendered by :meth:`EvalMatrixState.render_prometheus`
  and served by the shared ``obs.MetricsServer`` when the CLI is given
  ``--prometheus_port`` — a long sweep is scrapeable, not a black box;
* **one BENCH-style JSON** (``BENCH_eval_matrix.json``) holding the full
  success matrix — the offline promotion-gate signal the deploy
  controller (eval gate → canary → rollback) consumes.

Where the converted dataset is thin for a family, :func:`fill_pack`
generates per-task corpora with the scripted oracle (`envs/oracles/`,
episodes stamped with `data.collect.canonical_task_id` slugs) and feeds
them through the ``append_shard`` path — the flywheel corpus grows
*multi-task*, and task-mixture training (`config.data.task_weights`) has
data to weight.

Import-light by contract: stdlib + `rt1_tpu_torch.obs.prometheus` at module
scope; torch / envs / checkpoint machinery only inside functions, so the
module imports in the torch-free fleet supervisor.

Run:
  python -m rt1_tpu_torch.eval.matrix_main --config tiny --workdir /tmp/rt1 \
      --episodes 3 --device cpu
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from rt1_tpu_torch.obs import prometheus as obs_prometheus

#: BENCH-style record basename — written next to the checkpoints and
#: wherever the CLI's --out points.
BENCH_BASENAME = "BENCH_eval_matrix.json"


def default_task_names() -> Tuple[str, ...]:
    """Every canonical reward family, sorted — the matrix's task axis."""
    from rt1_tpu_torch.envs import rewards as rewards_module

    return tuple(sorted(rewards_module.REWARD_FAMILIES))


def checkpoint_steps(workdir: str, spec: str = "all") -> List[int]:
    """Checkpoint steps to evaluate, resolved from ``<workdir>/checkpoints``.

    `spec`: ``"all"`` — every retained step; ``"latest:N"`` — the newest N;
    or a comma-separated list of explicit steps (validated against disk).
    A step counts when its directory holds the trainer's whole
    `state.pt` (the deploy watcher's scan, the twin of
    `trainer.checkpoints.all_steps`: a save in flight is still
    `state.pt.tmp`), so this needs no torch import.
    """
    from rt1_tpu_torch.deploy.watcher import CheckpointWatcher

    ckpt_dir = os.path.join(workdir, "checkpoints")
    steps = CheckpointWatcher(workdir).pending_steps()
    spec = (spec or "all").strip()
    if spec == "all":
        return steps
    if spec.startswith("latest:"):
        n = int(spec.split(":", 1)[1])
        if n <= 0:
            raise ValueError(f"latest:N needs N >= 1, got {spec!r}")
        return steps[-n:]
    wanted = [int(s) for s in spec.split(",") if s.strip()]
    missing = sorted(set(wanted) - set(steps))
    if missing:
        raise ValueError(
            f"checkpoints {missing} not found under {ckpt_dir} "
            f"(on disk: {steps})"
        )
    return sorted(set(wanted))


class EvalMatrixState:
    """Thread-safe accumulator of matrix cells + the live gauge renderer.

    One cell per (task, checkpoint label); the sweep updates a cell after
    each `evaluate_policy` call, and a concurrent scraper reads a
    consistent snapshot — absence of a cell means "not reached yet", a
    cell with ``episodes == 0`` means "running now".
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (task, ckpt label) -> {"successes", "episodes", "mean_episode_
        # length"}; insertion-ordered = sweep order.
        self._cells: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._started_unix = time.time()

    def note_cell_start(self, task: str, checkpoint: str) -> None:
        with self._lock:
            self._cells.setdefault(
                (task, checkpoint),
                {"successes": 0, "episodes": 0, "mean_episode_length": 0.0},
            )

    def note_cell(
        self,
        task: str,
        checkpoint: str,
        successes: int,
        episodes: int,
        mean_episode_length: float = 0.0,
    ) -> None:
        with self._lock:
            cell = self._cells.setdefault(
                (task, checkpoint),
                {"successes": 0, "episodes": 0, "mean_episode_length": 0.0},
            )
            total = cell["episodes"] + episodes
            if total > 0:
                cell["mean_episode_length"] = (
                    cell["mean_episode_length"] * cell["episodes"]
                    + mean_episode_length * episodes
                ) / total
            cell["successes"] += int(successes)
            cell["episodes"] = total

    # ---------------------------------------------------------- reporting

    def matrix(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """{task: {checkpoint: cell}} with per-cell success_rate."""
        with self._lock:
            out: Dict[str, Dict[str, Dict[str, Any]]] = {}
            for (task, ckpt), cell in self._cells.items():
                row = out.setdefault(task, {})
                row[ckpt] = dict(
                    cell,
                    success_rate=(
                        cell["successes"] / cell["episodes"]
                        if cell["episodes"]
                        else 0.0
                    ),
                )
            return out

    def checkpoints(self) -> List[str]:
        """Checkpoint labels in sweep order (columns of the table)."""
        with self._lock:
            seen: List[str] = []
            for _, ckpt in self._cells:
                if ckpt not in seen:
                    seen.append(ckpt)
            return seen

    def render_prometheus(self) -> str:
        """The live-sweep scrape body: ``rt1_eval_*`` families.

        ``rt1_eval_success`` is the cell's success RATE so far (gauge,
        labeled {task, checkpoint}); ``rt1_eval_episodes_total`` counts
        completed episodes per cell. Task slugs ("unknown:<name>") ride
        the exposition label escaping like the serve-side task labels.
        """
        with self._lock:
            cells = {k: dict(v) for k, v in self._cells.items()}
            started = self._started_unix
        exp = obs_prometheus.TextExposition()
        exp.gauge(
            "rt1_eval_cells_total",
            len(cells),
            "Matrix cells started so far (tasks x checkpoints).",
        )
        exp.gauge(
            "rt1_eval_sweep_uptime_seconds",
            time.time() - started,
            "Wall seconds since the sweep started.",
        )
        if cells:
            exp.family(
                "rt1_eval_success",
                "gauge",
                [
                    (
                        {"task": task, "checkpoint": ckpt},
                        (
                            cell["successes"] / cell["episodes"]
                            if cell["episodes"]
                            else 0.0
                        ),
                    )
                    for (task, ckpt), cell in cells.items()
                ],
                "Closed-loop success rate per (task, checkpoint) cell.",
            )
            exp.family(
                "rt1_eval_episodes_total",
                "counter",
                [
                    ({"task": task, "checkpoint": ckpt}, cell["episodes"])
                    for (task, ckpt), cell in cells.items()
                ],
                "Episodes completed per (task, checkpoint) cell.",
            )
        return exp.render()


def policy_for_checkpoint(
    config,
    workdir: str,
    step: Optional[int],
    *,
    device=None,
):
    """(policy, restored_step, history_keys) for one checkpoint step.

    The per-step twin of `eval/main.py:load_policy_from_workdir` (which is
    pinned to the newest checkpoint): same family dispatch, explicit step,
    on `device` (default cuda); an RT-1 policy always takes the fused
    attention kernel, so every control step of a gate runs it.
    """
    from rt1_tpu_torch import resolve_device
    from rt1_tpu_torch.eval.main import eval_policy_for
    from rt1_tpu_torch.eval.restore import compute_dtype, master_policy

    model, restored = master_policy(
        config, None, workdir, "fused", step=step
    )
    model = model.to(
        device=resolve_device(device), dtype=compute_dtype(config)
    ).eval().requires_grad_(False)
    policy, history_keys = eval_policy_for(config, model)
    return policy, restored, history_keys


def run_matrix(
    policies: Sequence[Tuple[str, Any]],
    tasks: Sequence[str],
    *,
    episodes_per_cell: int = 3,
    max_episode_steps: int = 80,
    block_mode: str = "BLOCK_8",
    seed: int = 0,
    embedder: str = "hash",
    env_kwargs: Optional[Dict[str, Any]] = None,
    state: Optional[EvalMatrixState] = None,
    progress: Optional[Callable[[str, str, Dict[str, Any]], None]] = None,
) -> EvalMatrixState:
    """Sweep `policies` (label, policy-or-factory) × `tasks` through the
    closed-loop protocol, one `evaluate_policy` call per cell.

    Checkpoints are the OUTER loop so each policy is restored/walked once;
    an entry without an ``action`` attribute is treated as a zero-arg
    factory and called lazily here — so a long checkpoint list holds ONE
    restored parameter set in memory at a time, not all of them. The
    state updates after every cell, which is what makes the live gauges
    move during the sweep. `progress(task, label, cell)` fires per
    completed cell (the CLI logs it).
    """
    from rt1_tpu_torch.envs import blocks
    from rt1_tpu_torch.eval.evaluate import evaluate_policy

    state = state if state is not None else EvalMatrixState()
    mode = blocks.BlockMode(block_mode)
    for label, policy in policies:
        if not hasattr(policy, "action"):
            policy = policy()  # lazy restore: one checkpoint resident
        for task in tasks:
            state.note_cell_start(task, label)
            results = evaluate_policy(
                policy,
                reward_names=(task,),
                num_evals_per_reward=episodes_per_cell,
                max_episode_steps=max_episode_steps,
                block_mode=mode,
                seed=seed,
                embedder=embedder,
                env_kwargs=env_kwargs,
            )
            successes = int(results["successes"].get(task, 0))
            mean_len = float(
                results["mean_episode_length"].get(task, 0.0)
            )
            state.note_cell(
                task, label, successes, episodes_per_cell, mean_len
            )
            if progress is not None:
                progress(
                    task,
                    label,
                    {
                        "successes": successes,
                        "episodes": episodes_per_cell,
                        "mean_episode_length": mean_len,
                    },
                )
    return state


def run_gate(
    config,
    workdir: str,
    candidate_step: int,
    incumbent_step: Optional[int] = None,
    *,
    tasks: Optional[Sequence[str]] = None,
    episodes_per_cell: int = 2,
    max_episode_steps: int = 80,
    block_mode: str = "BLOCK_8",
    seed: int = 0,
    embedder: str = "hash",
    env_kwargs: Optional[Dict[str, Any]] = None,
    margin: float = 0.0,
    state: Optional[EvalMatrixState] = None,
    progress: Optional[Callable[[str, str, Dict[str, Any]], None]] = None,
    device=None,
) -> Dict[str, Any]:
    """The offline promotion gate as ONE library call: candidate vs.
    incumbent on the same task grid -> a verdict dict.

    Library entry for the deploy controller (the CLI keeps its own sweep
    loop): runs `run_matrix` over the two checkpoint columns with the
    same lazy policy factories the CLI builds — the incumbent column is
    restored, swept, and released before the candidate restores, so the
    caller never holds two parameter sets in memory.

    Pass criterion: candidate mean per-cell success must reach the
    incumbent's minus ``margin`` (>= incumbent - margin). With no
    incumbent (first deploy into an empty fleet) the candidate gates
    against 0.0 — any evaluable checkpoint passes, which is the honest
    floor when there is nothing to regress against. The verdict carries
    the full matrix so the signed artifact IS the evidence. Policies
    run on `device` (default cuda).
    """
    t0 = time.time()
    tasks = tuple(tasks) if tasks else default_task_names()
    columns: List[Tuple[str, Any]] = []
    if incumbent_step is not None:
        columns.append(
            (
                str(incumbent_step),
                lambda s=incumbent_step: policy_for_checkpoint(
                    config, workdir, s, device=device
                )[0],
            )
        )
    columns.append(
        (
            str(candidate_step),
            lambda s=candidate_step: policy_for_checkpoint(
                config, workdir, s, device=device
            )[0],
        )
    )
    state = run_matrix(
        columns,
        tasks,
        episodes_per_cell=episodes_per_cell,
        max_episode_steps=max_episode_steps,
        block_mode=block_mode,
        seed=seed,
        embedder=embedder,
        env_kwargs=env_kwargs,
        state=state,
        progress=progress,
    )
    matrix = state.matrix()

    def _mean(label: str) -> float:
        rates = [
            row[label]["success_rate"]
            for row in matrix.values()
            if label in row and row[label]["episodes"]
        ]
        return sum(rates) / len(rates) if rates else 0.0

    candidate_mean = _mean(str(candidate_step))
    incumbent_mean = (
        _mean(str(incumbent_step)) if incumbent_step is not None else 0.0
    )
    return {
        "gate": "eval_matrix",
        "candidate_step": int(candidate_step),
        "incumbent_step": (
            int(incumbent_step) if incumbent_step is not None else None
        ),
        "tasks": sorted(matrix),
        "episodes_per_cell": episodes_per_cell,
        "candidate_mean_success": round(candidate_mean, 4),
        "incumbent_mean_success": round(incumbent_mean, 4),
        "margin": margin,
        "passed": candidate_mean >= incumbent_mean - margin,
        "matrix": matrix,
        "wall_seconds": round(time.time() - t0, 1),
    }


def matrix_record(
    state: EvalMatrixState,
    *,
    episodes_per_cell: int,
    max_episode_steps: int,
    seed: int,
    embedder: str,
    backend: str,
    block_mode: str,
    wall_seconds: float,
    workdir: str = "",
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The BENCH-style JSON record: full matrix + one headline number
    (mean per-cell success rate — comparable across sweeps of the same
    grid, NOT across different grids)."""
    matrix = state.matrix()
    rates = [
        cell["success_rate"]
        for row in matrix.values()
        for cell in row.values()
        if cell["episodes"]
    ]
    record = {
        "bench": "eval_matrix",
        "unit": "mean_cell_success_rate",
        "value": round(sum(rates) / len(rates), 4) if rates else 0.0,
        "tasks": sorted(matrix),
        "checkpoints": state.checkpoints(),
        "matrix": matrix,
        "episodes_per_cell": episodes_per_cell,
        "max_episode_steps": max_episode_steps,
        "seed": seed,
        "embedder": embedder,
        "backend": backend,
        "block_mode": block_mode,
        "workdir": workdir,
        "wall_seconds": round(wall_seconds, 1),
    }
    if extra:
        record.update(extra)
    return record


def write_record(record: Dict[str, Any], *paths: str) -> List[str]:
    """Atomically write the BENCH record to every given path."""
    written = []
    for path in paths:
        if not path:
            continue
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        written.append(path)
    return written


# ----------------------------------------------------- oracle corpus fill


def collect_task_corpus(
    episodes_dir: str,
    tasks: Sequence[str],
    episodes_per_task: int,
    *,
    block_mode: str = "BLOCK_8",
    seed: int = 0,
    max_steps: int = 80,
    embedder: str = "hash",
    image_hw: Optional[Tuple[int, int]] = None,
    max_attempts_factor: int = 8,
) -> Dict[str, List[str]]:
    """Oracle-generate `episodes_per_task` demos per reward family, each
    stamped with its canonical task id, into `episodes_dir`.

    Returns {task: [episode paths]}. A family the oracle cannot solve
    within ``episodes_per_task * max_attempts_factor`` attempts reports
    fewer (possibly zero) episodes instead of hanging — the matrix's
    corpus fill must degrade loudly, not block the sweep.
    """
    from rt1_tpu_torch.data import collect as collect_lib
    from rt1_tpu_torch.data.episodes import save_episode
    from rt1_tpu_torch.envs import LanguageTable, blocks
    from rt1_tpu_torch.envs import rewards as rewards_module
    from rt1_tpu_torch.envs.oracles import RRTPushOracle
    from rt1_tpu_torch.eval.embedding import get_embedder

    os.makedirs(episodes_dir, exist_ok=True)
    embed_fn = get_embedder(embedder)
    mode = blocks.BlockMode(block_mode)
    out: Dict[str, List[str]] = {}
    for t_i, task in enumerate(tasks):
        env = LanguageTable(
            block_mode=mode,
            reward_factory=rewards_module.get_reward_factory(task),
            seed=seed + t_i,
        )
        oracle = RRTPushOracle(env, use_ee_planner=True, seed=seed + t_i)
        slug = collect_lib.canonical_task_id(task)
        paths: List[str] = []
        attempts = 0
        while (
            len(paths) < episodes_per_task
            and attempts < episodes_per_task * max_attempts_factor
        ):
            attempts += 1
            ep = collect_lib.collect_episode(
                env,
                oracle,
                embed_fn,
                max_steps=max_steps,
                image_hw=image_hw,
                task=slug,
            )
            if ep is None:
                continue
            path = os.path.join(
                episodes_dir,
                f"episode_{slug.replace(':', '_')}_{len(paths)}.npz",
            )
            save_episode(path, ep)
            paths.append(path)
        out[task] = paths
    return out


def fill_pack(
    pack_dir: str,
    episodes_dir: str,
    tasks: Sequence[str],
    episodes_per_task: int,
    *,
    block_mode: str = "BLOCK_8",
    seed: int = 0,
    max_steps: int = 80,
    embedder: str = "hash",
) -> Dict[str, Any]:
    """Oracle corpora → the append path: collect per-task episodes
    at the pack's source geometry and `append_shard` them, bumping the
    manifest's freshness epoch so a live train job's feeder absorbs the
    multi-task shard at its next epoch boundary.

    Returns a summary {task: episodes_collected, shards_after, ...}.
    """
    from rt1_tpu_torch.data import pack as pack_lib

    manifest = pack_lib.load_manifest(pack_dir)
    image_hw = (
        int(manifest["source"]["height"]),
        int(manifest["source"]["width"]),
    )
    collected = collect_task_corpus(
        episodes_dir,
        tasks,
        episodes_per_task,
        block_mode=block_mode,
        seed=seed,
        max_steps=max_steps,
        embedder=embedder,
        image_hw=image_hw,
    )
    paths = [p for ps in collected.values() for p in ps]
    if paths:
        manifest = pack_lib.append_shard(pack_dir, paths)
    return {
        "episodes_per_task": {t: len(ps) for t, ps in collected.items()},
        "episodes_appended": len(paths),
        "shards_after": len(manifest["shards"]),
        "freshness_epoch": int(manifest.get("freshness_epoch", 0)),
        "corpus_tasks": sorted(
            {
                e.get("task") or pack_lib.UNKNOWN_TASK
                for e in manifest["episodes"]
            }
        ),
    }
