"""Checkpoints of the train state (counterpart of
`rt1_tpu/trainer/checkpoints.py`, which writes Orbax).

The port's own format, one `torch.save` file per step at
`<directory>/<step>/state.pt` (`step` is the loop's step count at the
save): the policy's `state_dict` (float32 masters and BatchNorm
statistics), the optimizer's count and flat moments, the applied-update
and guard-skip counters, and the generator state. The generators are
reseeded from `(seed, step)` every step, so `seed` and the loop step are
their whole state. Nothing is read or written in Orbax's format.

A save writes `state.pt.tmp` and renames it over `state.pt`
(`os.replace`), so a reader sees a whole file or none; `latest_step`
counts only directories that hold `state.pt`, or a manifest.

A multi-process run (a manager with a `grid` of an initialized world, or
a ZeRO-3 state) writes the SHARDED format instead (JAX's Orbax writes per
host shards too): the writer of each fsdp chunk (the rank at data
coordinate 0 and seq coordinate 0 of its fsdp line) writes
`shard_<f>_of_<F>.pt` with its chunk of the masters and both moments,
rank 0 writes `replicated.pt` (the BatchNorm statistics and other buffers,
the counters, the generator state) and then, after a barrier, the
`manifest.json` that makes the step complete: the world, the rank grid,
the padded and logical lengths, every parameter's name and shape, the
shard files, and JAX's provenance (process and device counts). Rank 0
alone also writes `<directory>/saved_under.json` and prunes. A step
directory without its manifest is torn and not a step. `load_checkpoint`
reads either format into the one-file layout (the logical flat vectors;
`parallel/reshard.py`), and `restore` slices them for the state's own
plan, so a checkpoint moves between fsdp sizes, data parallelism and the
world of one unchanged.

Under tensor or pipeline parallelism (a state with a `partition`,
`parallel/partition.py`) each (stage, model) coordinate holds another
part of the policy: its writers (data 0, seq 0) write
`part_s<stage>_m<model>_shard_<f>_of_<F>.pt`, each with its part's chunk
and, at fsdp index 0, its part's buffers, and the manifest records the
partition (the logical names and shapes, each split leaf's dimension,
each layer's stage) and every part's names, shapes and files.
`load_checkpoint` assembles the logical tensors from the parts, and
`restore` cuts them for the target's part, so tp and pp checkpoints
restore under any plan and into the one-device serving engine.

Retention follows the Orbax manager that the JAX package configures
(`CheckpointManagerOptions(max_to_keep, keep_period)`): after each save,
a step stays if it is among the newest `max_to_keep` steps on disk (None
keeps every step) or if `step % keep_period == 0`. Steps kept by the period
count among the newest, as in Orbax, whose `LatestN` policy ranks every
retained step.

Resilience, as in the JAX manager: `retry` wraps each save and restore in
exponential-backoff retry (`resilience/retry.py`), so a transient
filesystem error costs a logged warning instead of the run; `on_io(name,
seconds)` reports each logical operation's wall time, retries included
(the goodput ledger's `note_io`); the `ckpt_save` / `ckpt_restore` fault
sites fire before the real I/O and are indexed by the logical operation,
not the attempt, so `ckpt_save@1` fails the first save's first attempt and
its retry truly succeeds; and `restore_or_initialize` falls back past a
corrupt newest step to the next older one, raising only when every step
fails.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from rt1_tpu_torch.parallel import reshard
from rt1_tpu_torch.parallel.partition import Partition
from rt1_tpu_torch.resilience import faults
from rt1_tpu_torch.resilience.retry import RetryOptions, retry_call
from rt1_tpu_torch.trainer.state import FlatLayout, TrainState

_log = logging.getLogger(__name__)

FILENAME = "state.pt"
FORMAT = "rt1_tpu_torch.trainer/1"
MANIFEST = "manifest.json"
REPLICATED = "replicated.pt"
SHARDED_FORMAT = "rt1_tpu_torch.trainer/sharded-1"
PROVENANCE = "saved_under.json"


def shard_filename(index: int, count: int, part: Optional[Tuple[int, int]] = None) -> str:
    """The file of fsdp chunk `index` of `count`; under tp or pp, of the
    (stage, model) `part`."""
    name = f"shard_{index:05d}_of_{count:05d}.pt"
    return name if part is None else f"part_s{part[0]:03d}_m{part[1]:03d}_{name}"


def _load_parts(step_dir: str, manifest: Dict) -> Tuple[Dict, Dict]:
    """(the logical {"flat", "mu", "nu"} vectors, the parts' buffers) of a
    partitioned manifest."""
    partition = Partition.from_manifest(manifest["partition"])
    per_part, buffers = {}, {}
    for part in manifest["parts"]:
        shards = [torch.load(os.path.join(step_dir, name), map_location="cpu", weights_only=True)
                  for name in part["shards"]]
        buffers.update(shards[0].get("buffers", {}))
        per_part[(part["stage"], part["model"])] = {
            key: reshard.assemble_flat([sh[key] for sh in shards], int(part["layout_size"]))
            for key in ("flat", "mu", "nu")}
    vectors = {key: partition.logical_flat({k: v[key] for k, v in per_part.items()})
               for key in ("flat", "mu", "nu")}
    return vectors, buffers


def _write_json(path: str, record: Dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def all_steps(directory: str) -> List[int]:
    """Steps with a complete checkpoint under `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.isdigit() and any(os.path.isfile(os.path.join(directory, name, f))
                                  for f in (FILENAME, MANIFEST)):
            steps.append(int(name))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, str(step), FILENAME)


def load_checkpoint(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The saved dict of `step` (default: the newest), on the CPU, in the
    one-file layout whatever the format: a sharded step's chunks are
    assembled into the logical masters ("flat") and moments, and its
    parameters unflattened into "policy" beside the buffers."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    step_dir = os.path.join(directory, str(step))
    if not os.path.isfile(os.path.join(step_dir, MANIFEST)):
        return torch.load(checkpoint_path(directory, step), map_location="cpu", weights_only=True)
    with open(os.path.join(step_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != SHARDED_FORMAT:
        raise ValueError(f"not a {SHARDED_FORMAT} manifest: {manifest.get('format')!r}")
    shards = [torch.load(os.path.join(step_dir, name), map_location="cpu", weights_only=True)
              for name in manifest.get("shards", [])]
    replicated = torch.load(os.path.join(step_dir, REPLICATED), map_location="cpu",
                            weights_only=True)
    buffers = dict(replicated["buffers"])
    if "parts" in manifest:
        vectors, part_buffers = _load_parts(step_dir, manifest)
        flat, mu, nu = vectors["flat"], vectors["mu"], vectors["nu"]
        buffers.update(part_buffers)
    else:
        size = int(manifest["layout_size"])
        flat, mu, nu = (reshard.assemble_flat([s[key] for s in shards], size)
                        for key in ("flat", "mu", "nu"))
    params = reshard.unflatten(flat, manifest["names"], manifest["shapes"], manifest["align"])
    return {
        "format": FORMAT,
        "sharded": manifest,
        "loop_step": replicated["loop_step"],
        "step": replicated["step"],
        "guard_skips": replicated["guard_skips"],
        "policy": {**params, **buffers},
        "flat": flat,
        "optimizer": {"count": replicated["count"], "mu": mu, "nu": nu},
        "rng": replicated["rng"],
    }


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None, seed: int = 0,
                 keep_period: Optional[int] = None, retry: Optional[RetryOptions] = None,
                 on_io: Optional[Callable[[str, float], None]] = None, grid: Any = None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be None (keep all) or >= 1, got {max_to_keep}")
        if keep_period is not None and keep_period < 1:
            raise ValueError(f"keep_period must be None or >= 1, got {keep_period}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self.seed = seed
        self.retry = retry
        self.on_io = on_io
        # The rank grid of a multi-process run (`parallel.mesh.RankGrid`):
        # with a process group the saves are sharded and collective.
        self.grid = grid
        # Logical-operation ordinals of the fault sites: one per save or
        # restore, not per retry attempt.
        self._save_ops = 0
        self._restore_ops = 0

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def all_steps(self) -> List[int]:
        return all_steps(self.directory)

    def _io(self, fn, name: str):
        """Run an I/O closure, retried per `retry` (once without); reports
        the whole operation's wall time, every attempt, to `on_io`."""
        t0 = time.perf_counter()
        try:
            if self.retry is None:
                return fn()
            return retry_call(fn, options=self.retry, name=name)
        finally:
            if self.on_io is not None:
                try:
                    self.on_io(name, time.perf_counter() - t0)
                except Exception:  # noqa: BLE001 - accounting only
                    pass

    def _sharded(self, state: TrainState) -> bool:
        return state.shard is not None or (self.grid is not None and self.grid.distributed)

    def save(self, step: int, state: TrainState) -> str:
        """Write `state` as checkpoint `step` and prune old ones; returns
        the file's path (the manifest's, sharded). Sharded, every rank
        calls it."""
        if self._sharded(state):
            return self._save_sharded(step, state)
        self._save_ops += 1
        op = self._save_ops
        opt = state.opt_state
        payload = {
            "format": FORMAT,
            "loop_step": int(step),
            "step": int(state.step),
            "guard_skips": int(state.guard_skips),
            "policy": {k: v.detach().cpu() for k, v in state.policy.state_dict().items()},
            "optimizer": {"count": int(opt.count), "mu": opt.mu.cpu(), "nu": opt.nu.cpu()},
            "rng": {"seed": int(self.seed), "step": int(step)},
        }
        path = checkpoint_path(self.directory, step)

        def _save():
            faults.maybe_fail("ckpt_save", index=op, what=f"save at step {step}")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(payload, path + ".tmp")
            os.replace(path + ".tmp", path)

        self._io(_save, "ckpt_save")
        self._prune()
        return path

    def _save_sharded(self, step: int, state: TrainState) -> str:
        import torch.distributed as dist

        self._save_ops += 1
        op = self._save_ops
        grid = self.grid
        rank = grid.rank if grid is not None else 0
        coords = grid.coords if grid is not None else {}
        shard = state.shard
        index, count = (shard.index, shard.count) if shard is not None else (0, 1)
        step_dir = os.path.join(self.directory, str(step))
        writes_shard = coords.get("data", 0) == 0 and coords.get("seq", 0) == 0
        opt = state.opt_state
        param_names = set(state.names)
        partition = state.partition
        part = (partition.stage_index, partition.model_index) if partition is not None else None

        def _save():
            faults.maybe_fail("ckpt_save", index=op, what=f"save at step {step}")
            os.makedirs(step_dir, exist_ok=True)
            if writes_shard:
                path = os.path.join(step_dir, shard_filename(index, count, part))
                payload = {"flat": state.flat.detach().cpu(), "mu": opt.mu.detach().cpu(),
                           "nu": opt.nu.detach().cpu()}
                if part is not None and index == 0:   # the part's buffers
                    payload["buffers"] = {k: v.detach().cpu()
                                          for k, v in state.policy.state_dict().items()
                                          if k not in param_names}
                torch.save(payload, path + ".tmp")
                os.replace(path + ".tmp", path)
            if rank == 0:
                path = os.path.join(step_dir, REPLICATED)
                buffers = {k: v.detach().cpu() for k, v in state.policy.state_dict().items()
                           if k not in param_names}
                torch.save({"loop_step": int(step), "step": int(state.step),
                            "guard_skips": int(state.guard_skips), "count": int(opt.count),
                            "buffers": buffers,
                            "rng": {"seed": int(self.seed), "step": int(step)}}, path + ".tmp")
                os.replace(path + ".tmp", path)

        self._io(_save, "ckpt_save")
        distributed = dist.is_available() and dist.is_initialized()
        if distributed:
            dist.barrier()
        manifest_path = os.path.join(step_dir, MANIFEST)
        if rank == 0:
            layout = state.layout
            world = grid.world if grid is not None else 1
            record = {
                "format": SHARDED_FORMAT,
                "step": int(step),
                "world": world,
                "mesh": grid.mesh.shape if grid is not None else {},
                "fsdp": count,
                "padded_size": shard.size if shard is not None else layout.size,
                "layout_size": layout.size,
                "align": FlatLayout.ALIGN,
                "names": list(state.names),
                "shapes": [list(sh) for sh in layout.shapes],
                "shards": [shard_filename(i, count) for i in range(count)],
                # JAX's provenance (`saved_under.json`): one process, one device a rank.
                "process_count": world,
                "device_count": world,
                "local_device_count": 1,
            }
            if partition is not None:
                record.update(self._part_records(partition, count))
            _write_json(manifest_path, record)
            self._write_provenance(step, grid)
            self._prune()
        if distributed:
            dist.barrier()
        return manifest_path

    @staticmethod
    def _part_records(partition: Partition, count: int) -> Dict:
        """The manifest's logical layout, partition and parts."""
        parts = []
        for stage in range(partition.stage_ways):
            names, shapes = partition.part(stage)
            size = FlatLayout.of_shapes(shapes).size
            for model in range(partition.model_ways):
                parts.append({"stage": stage, "model": model, "names": names,
                              "shapes": [list(sh) for sh in shapes], "layout_size": size,
                              "padded_size": -(-size // count) * count,
                              "shards": [shard_filename(i, count, (stage, model))
                                         for i in range(count)]})
        return {"names": list(partition.names),
                "shapes": [list(sh) for sh in partition.shapes],
                "layout_size": FlatLayout.of_shapes(partition.shapes).size,
                "padded_size": None, "shards": [],
                "partition": partition.to_manifest(), "parts": parts}

    def _write_provenance(self, step: int, grid) -> None:
        """`<directory>/saved_under.json`, rank 0 only (best effort, as
        JAX's: provenance must never take checkpointing down)."""
        world = grid.world if grid is not None else 1
        try:
            _write_json(os.path.join(self.directory, PROVENANCE), {
                "step": int(step), "process_count": world, "device_count": world,
                "local_device_count": 1, "written_at_unix": time.time()})
        except OSError:
            pass

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        steps = all_steps(self.directory)
        for step in steps[: max(len(steps) - self.max_to_keep, 0)]:
            if self.keep_period is not None and step % self.keep_period == 0:
                continue
            shutil.rmtree(os.path.join(self.directory, str(step)), ignore_errors=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> int:
        """Load checkpoint `step` (default: the newest) into `state` in
        place; returns the loop step it was saved at."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        self._restore_ops += 1
        op = self._restore_ops

        def _load():
            faults.maybe_fail("ckpt_restore", index=op, what=f"restore step {step}")
            return load_checkpoint(self.directory, step)

        ckpt = self._io(_load, "ckpt_restore")
        if ckpt.get("format") != FORMAT:
            raise ValueError(f"not a {FORMAT} checkpoint: {ckpt.get('format')!r}")
        # Checked before anything is copied, so a step that fails leaves
        # `state` as it was for the fallback to an older one.
        manifest = ckpt.get("sharded")
        partition = state.partition
        keys = partition.keys if partition is not None else state.policy.state_dict()
        if set(ckpt["policy"]) != set(keys) or \
                not {"count", "mu", "nu"} <= set(ckpt["optimizer"]) or \
                (manifest is not None and (
                    manifest["names"] != list(state.logical_names)
                    or [tuple(s) for s in manifest["shapes"]] != state.logical_shapes)):
            raise ValueError(f"checkpoint step {step} does not match the train state")
        opt = state.opt_state
        if partition is not None:
            self._restore_part(state, ckpt)
        elif state.shard is None:
            state.policy.load_state_dict(ckpt["policy"])
        else:  # the masters take their chunk; the placeholders stay
            flat = ckpt.get("flat")
            if flat is None:
                flat = state.layout.flatten([ckpt["policy"][n] for n in state.names])
            params = set(state.names)
            with torch.no_grad():
                for name, buf in state.policy.named_buffers():
                    if name not in params and name in ckpt["policy"]:
                        buf.copy_(ckpt["policy"][name])
            state.flat.copy_(reshard.place_flat(flat, state.shard))
        opt.count.fill_(ckpt["optimizer"]["count"])
        if partition is None:
            opt.mu.copy_(reshard.place_flat(ckpt["optimizer"]["mu"], state.shard))
            opt.nu.copy_(reshard.place_flat(ckpt["optimizer"]["nu"], state.shard))
        state.step.fill_(ckpt["step"])
        state.guard_skips.fill_(ckpt["guard_skips"])
        return int(ckpt["loop_step"])

    @staticmethod
    def _restore_part(state: TrainState, ckpt: Dict[str, Any]) -> None:
        """The logical masters and moments of `ckpt` cut for the state's
        part (its model slices, its stage's layers, its fsdp chunk), and
        its buffers."""
        partition = state.partition
        names, shapes = partition.names, partition.shapes
        align = FlatLayout.ALIGN
        flat = ckpt.get("flat")
        params = ckpt["policy"] if flat is None else reshard.unflatten(flat, names, shapes, align)
        mu = reshard.unflatten(ckpt["optimizer"]["mu"], names, shapes, align)
        nu = reshard.unflatten(ckpt["optimizer"]["nu"], names, shapes, align)

        def local(tensors):
            return state.layout.flatten([partition.local(n, tensors[n]) for n in state.names])

        params_set = set(state.names)
        with torch.no_grad():
            for name, buf in state.policy.named_buffers():
                if name not in params_set and name in ckpt["policy"]:
                    buf.copy_(ckpt["policy"][name])
            for target, tensors in ((state.flat, params), (state.opt_state.mu, mu),
                                    (state.opt_state.nu, nu)):
                target.copy_(reshard.place_flat(local(tensors), state.shard))

    def restore_or_initialize(self, state: TrainState) -> Tuple[TrainState, int]:
        """(state, loop step to start from): the newest checkpoint that
        restores, else `state` as given and 0. A corrupt or partial step is
        logged and passed over for the next older one; when every step
        fails, the error of the oldest raises."""
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return state, 0
        last_exc: Optional[Exception] = None
        for step in steps:
            try:
                return state, self.restore(state, step)
            except Exception as exc:  # noqa: BLE001 - fall back per step
                last_exc = exc
                _log.error("checkpoint: restore of step %d in %s FAILED (%s: %s)%s", step,
                           self.directory, type(exc).__name__, exc,
                           " — falling back to the previous retained step"
                           if step != steps[-1] else " — no older step to fall back to")
        raise last_exc
