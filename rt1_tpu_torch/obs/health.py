"""Model-health pack: is the model *learning*, not just stepping.

The port's counterpart of `rt1_tpu/obs/health.py`, with the same entry
names in the same order, so `health/*` scalars and `rt1_train_health_*`
gauges read alike from both packages:

* ``health/grad_norm/<group>``     — L2 norm of the gradients per layer
  group: the parameter's **flax** path (`convert.flax_paths`, without the
  ``params/`` collection) truncated to `depth` segments, e.g.
  ``transformer/layer_3``. The port's own state_dict names differ; the
  flax names keep dashboards and `scripts/run_report.py` reading the same
  keys.
* ``health/update_ratio/<group>``  — ||params_new - params_old|| /
  (||params_new|| + eps), post-optimizer.
* ``health/param_norm_global``, ``health/update_norm_global``.
* ``health/logit_entropy``         — mean action-token softmax entropy in
  nats.
* ``health/token_acc/dim<k>``      — per-action-dimension token accuracy.
* ``health/task_loss/<task>`` / ``task_acc`` / ``task_frac`` — per task,
  when the feeder emits per-example task ids (:data:`TASK_ID_KEY`).

The train step (`trainer/train.py`) computes the pack on the card from the
flat float32 layout of the train state: one square and one segmented sum
per flat tensor give every parameter's sum of squares, and a product with
a fixed one-hot (parameters x groups) matrix sums them by group, so the
pack adds a few dozen launches a step however many parameters there are.
It stacks into ONE float32 vector that stays on the device and is fetched
only at log steps: no per-step host sync. With the pack off, the step is
the one without it, bit for bit.

Import-light by contract: torch only inside functions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

#: Key under which the packed vector rides in the step metrics dict.
PACK_KEY = "health_pack"

#: Observation key carrying the per-example int32 task ids the feeder
#: emits (`SampleAheadFeeder(emit_task_ids=True)`). The train step strips
#: it from the observations before the model forward.
TASK_ID_KEY = "task_id"

#: Guard against division by a zero param norm (fresh zeros-init leaves).
_EPS = 1e-12

#: Default group depth: 2 path segments gives per-layer granularity on the
#: RT-1 tree (``transformer/layer_3``) without per-kernel explosion.
DEFAULT_GROUP_DEPTH = 2


def _group_of(path: str, depth: int) -> str:
    return "/".join(path.split("/")[:depth])


def param_groups(paths: Sequence[str], depth: int = DEFAULT_GROUP_DEPTH) -> List[str]:
    """Sorted group names: the flax parameter paths (``transformer/layer_0/
    ff/kernel``) truncated to `depth` segments."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    return sorted({_group_of(p, depth) for p in paths})


def param_paths(policy) -> List[str]:
    """The flax path of each of `policy`'s parameters, in
    `named_parameters()` order (the train state's layout), without the
    ``params/`` collection."""
    from rt1_tpu_torch.convert import flax_paths

    paths = flax_paths(policy)
    return [paths[name].split("/", 1)[1] for name, _ in policy.named_parameters()]


def pack_names(
    paths: Sequence[str],
    depth: int = DEFAULT_GROUP_DEPTH,
    action_dims: int = 0,
    prefix: str = "health/",
    task_names: Sequence[str] = (),
) -> Tuple[str, ...]:
    """The pack's entry names, in pack order (JAX's `pack_names` for the
    parameter tree whose leaf paths are `paths`)."""
    groups = param_groups(paths, depth)
    names = [f"{prefix}grad_norm/{g}" for g in groups]
    names += [f"{prefix}update_ratio/{g}" for g in groups]
    names += [f"{prefix}param_norm_global", f"{prefix}update_norm_global"]
    if action_dims > 0:
        names.append(f"{prefix}logit_entropy")
        names += [f"{prefix}token_acc/dim{k}" for k in range(action_dims)]
        names += [f"{prefix}task_loss/{t}" for t in task_names]
        names += [f"{prefix}task_acc/{t}" for t in task_names]
        names += [f"{prefix}task_frac/{t}" for t in task_names]
    return tuple(names)


class HealthPack:
    """The pack of one train state's layout: its names, and `compute` on
    the card.

    `paths` are the flax paths of the state's parameters in layout order;
    `padded` the layout's per-parameter padded lengths (`FlatLayout.padded`,
    whose padding the state keeps at zero in the parameters, gradients and
    updates alike). Under tensor or pipeline parallelism the state holds a
    rank's part of the policy: `groups_of` names the logical (world of
    one's) paths the groups come from, and `classes` each leaf's class
    (`parallel/partition.py::leaf_class`), by which `compute` sums the
    groups over the `model` and `stage` ranks.
    """

    def __init__(self, paths: Sequence[str], padded: Sequence[int], device,
                 depth: int = DEFAULT_GROUP_DEPTH, action_dims: int = 0,
                 task_names: Sequence[str] = (), chunk: Optional[Tuple[int, int]] = None,
                 groups_of: Optional[Sequence[str]] = None,
                 classes: Optional[Sequence[int]] = None):
        import torch

        groups_of = paths if groups_of is None else groups_of
        self.groups = param_groups(groups_of, depth)
        self.action_dims = int(action_dims)
        self.task_names = tuple(task_names) if action_dims > 0 else ()
        self.names = pack_names(groups_of, depth, self.action_dims, task_names=self.task_names)
        index = {g: i for i, g in enumerate(self.groups)}
        onehot = torch.zeros((len(paths), len(self.groups)), dtype=torch.float32)
        for leaf, path in enumerate(paths):
            onehot[leaf, index[_group_of(path, depth)]] = 1.0
        lengths = leaf_lengths(padded, chunk)
        if chunk is not None:
            onehot = torch.cat([onehot, torch.zeros((1, len(self.groups)))])
        if classes is not None:   # (4, leaves, groups): each class's leaves alone
            mask = torch.zeros((4, onehot.shape[0], 1), dtype=torch.float32)
            for leaf, c in enumerate(classes):
                mask[c, leaf] = 1.0
            onehot = mask * onehot[None]
        self._classes = classes is not None
        self._onehot = onehot.to(device=device, dtype=torch.float64)
        self._lengths = torch.tensor(lengths, dtype=torch.int64, device=device)

    def _group_sumsq(self, flat):
        """Each group's sum of squares, accumulated in float64:
        `segment_reduce` sums a segment in order on the CPU (1e-3 relative
        error over 2M float32 squares)."""
        import torch

        per_leaf = torch.segment_reduce(torch.square(flat.double()), "sum",
                                        lengths=self._lengths, initial=0.0)
        return per_leaf @ self._onehot

    def compute(self, grad, update, new_flat, out: Mapping[str, Any], comms=None):
        """The float32 pack vector, in `names` order, from the flat float32
        gradient, the applied update (`new_flat - old_flat`), the updated
        masters and the loss's aux dict (`action_logits`,
        `action_predictions`, `action_labels`, `action_loss`, and
        `task_ids` when the pack has tasks). With `comms` (the train step's
        `parallel.collectives.StepComms`) every entry is global: the squared
        sums of the chunks summed over the fsdp ranks, the action
        statistics over the ranks' rows."""
        import torch

        grad_sq, upd_sq, new_sq = (self._group_sumsq(v) for v in (grad, update, new_flat))
        if self._classes:   # (4, groups) each: summed per class over its axes
            grad_sq, upd_sq, new_sq = comms.reduce_classes(
                torch.stack([grad_sq, upd_sq, new_sq], dim=1)).unbind(0)
        elif comms is not None:
            grad_sq, upd_sq, new_sq = comms.sum_shards(
                torch.stack([grad_sq, upd_sq, new_sq])).unbind(0)
        parts = [
            torch.sqrt(grad_sq),
            torch.sqrt(upd_sq) / (torch.sqrt(new_sq) + _EPS),
            torch.sqrt(new_sq.sum())[None],
            torch.sqrt(upd_sq.sum())[None],
        ]
        parts = [p.to(torch.float32) for p in parts]
        if self.action_dims > 0:
            logits = out["action_logits"].to(torch.float32)
            logp = torch.log_softmax(logits, dim=-1)
            entropy = -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))[None]
            correct = (out["action_predictions"] == out["action_labels"]).to(torch.float32)
            per_dim = correct.mean(dim=(0, 1))  # (A,)
            if per_dim.shape[0] != self.action_dims:
                raise ValueError(f"action_dims={self.action_dims} but the step produced "
                                 f"{per_dim.shape[0]} action token dims")
            if comms is not None:  # equal blocks: the mean of means
                entropy, per_dim = comms.mean_rows(torch.cat([entropy, per_dim])).split(
                    [1, self.action_dims])
            parts += [entropy, per_dim]
            if self.task_names:
                task_ids = out["task_ids"].to(torch.int64)  # (b,)
                per_ex_loss = out["action_loss"].to(torch.float32).mean(dim=-1)  # (b,)
                if comms is not None:
                    # The reference loss scale: a rank's rows carry W times
                    # their share of the global batch's loss.
                    per_ex_loss = per_ex_loss / comms.ways
                per_ex_acc = correct.mean(dim=(1, 2))  # (b,)
                onehot = torch.nn.functional.one_hot(
                    task_ids, len(self.task_names)).to(torch.float32)  # (b, K)
                sums = torch.stack([onehot.sum(dim=0), onehot.T @ per_ex_loss,
                                    onehot.T @ per_ex_acc])
                rows = float(task_ids.shape[0])
                if comms is not None:
                    sums, rows = comms.sum_rows(sums), rows * comms.ways
                counts, loss_sum, acc_sum = sums.unbind(0)
                denom = torch.clamp(counts, min=1.0)
                parts.append(loss_sum / denom)
                parts.append(acc_sum / denom)
                parts.append(counts / rows)
        return torch.cat(parts).to(torch.float32)


def leaf_lengths(padded: Sequence[int], chunk: Optional[Tuple[int, int]] = None) -> List[int]:
    """Each leaf's length in a flat layout (`FlatLayout.padded`), or,
    under a ZeRO-3 chunk [lo, hi) of the layout padded past its end, each
    leaf's part inside the chunk and a last segment of padding."""
    lengths = list(padded)
    if chunk is not None:
        lo, hi = chunk
        starts = [0]
        for n in padded[:-1]:
            starts.append(starts[-1] + n)
        lengths = [max(0, min(s + n, hi) - max(s, lo)) for s, n in zip(starts, padded)]
        lengths.append(hi - lo - sum(lengths))
    return lengths


def unpack(names: Sequence[str], vector: Any) -> Dict[str, float]:
    """Fetched pack vector -> {name: float} for the scalar stream (this
    waits for the card when the vector lives there)."""
    import numpy as np

    if hasattr(vector, "detach"):
        vector = vector.detach().to("cpu").numpy()
    values = np.asarray(vector, dtype=np.float64).reshape(-1)
    if values.shape[0] != len(names):
        raise ValueError(
            f"health pack length {values.shape[0]} != {len(names)} names — "
            f"the step builder and the host disagree on the layout"
        )
    return {name: float(v) for name, v in zip(names, values)}
