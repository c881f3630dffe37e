"""The train and eval steps (counterpart of `rt1_tpu/trainer/train.py`).

`TrainStepFns` holds the two steps over a `TrainState`
(`train_step_fns_from_config` builds it from a config):

* `train_step(state, batch, step)` runs forward and backward in train mode
  and one optimizer update, in place, and returns the metrics `loss`,
  `grad_norm` and (without accumulation) `action_loss_mean`, plus
  `aux_mse` when the auxiliary is on, `moe_aux_loss` with the MoE FFN
  (whose weighted load-balancing loss the train loss includes; a mean
  over micro-batches under accumulation) and `guard_skips_cum` with the guard,
  as device tensors: nothing waits for the card until the caller reads
  them (`trainer.metrics.scalars_from_metrics`).
* `eval_step(state, batch)` runs the eval-mode forward and returns `loss`
  and `token_accuracy` (the loss alone for another family's `loss_fn`).

`loss_fn` plugs another model family into both steps: the LAVA family's
MSE (`trainer/bc.py::make_bc_step_loss_fn`), as JAX's
`make_train_step_fns(loss_fn=...)` does.

Precision: the masters stay float32 (`state.flat`, which the policy's
parameters view; the update is written into it). Each step casts them
ONCE to the compute dtype (bf16 for the flagship, `_compute_copy`, the
counterpart of JAX's `_bf16_compute_copy`) and runs the policy on that
copy through `torch.func.functional_call`; the modules compute in the
dtype of their weights, as flax's `dtype=` does, and keep their float32
regions explicit (attention logits and softmax, the loss, BatchNorm
statistics). There is no autocast: under autocast the dense attention's
float32 einsum would run in bf16 again. The gradient arrives in the
compute dtype and is taken to float32; the optimizer steps the float32
masters.

Randomness: the crop, dropout, stochastic depth and (with
`photometric_augmentation` on) the photometric augmentation each draw from
a `torch.Generator` of their own on the step's device, seeded from
`(seed, step)` (and the micro-batch under accumulation), so a resumed run
draws what an unbroken one would have. The card's generator (Philox) and
the host's (Mersenne Twister) draw different numbers from one seed, so a
step that draws differs between the card and the CPU; with
`crop_on_host` the crop's generator is the host's on every device, and a
step whose only draw is the crop (no dropout, no stochastic depth, no
augmentation) computes the same on both.

Accumulation (`accum_steps > 1`) splits the batch into micro-batches,
sums their gradients and applies one update. Under the reference loss
scale the loss is inversely proportional to the batch, so a micro-batch
of b/accum gives accum times the full-batch loss; one extra `/accum` makes
the sum exact, as in JAX.

The guard (`guard_nonfinite`) drops an update whose loss or gradient norm
is not finite, or whose gradient norm exceeds `guard_grad_norm_max` when
that is > 0: parameters, optimizer state, BatchNorm statistics and `step`
stay exactly as they were and `guard_skips` counts one. Like JAX's
`jnp.where` select, it selects on the device and needs no host sync; on a
healthy step the select is the identity, bit for bit.

The model-health pack (`model_health`, `obs/health.py`) adds one float32
vector under `metrics[obs.health.PACK_KEY]`, computed on the device from
the gradient, the optimizer's update (`new_flat - flat`, before the guard's
select, as JAX computes it from `apply_gradients`' updates) and the loss's
aux dict; `health_names(state)` names its entries. With the pack off the
step is the step without it, bit for bit. A batch whose observations carry
`obs.health.TASK_ID_KEY` (the feeder's `emit_task_ids`) has it stripped
before the model, and with `health_task_names` the pack reduces its
per-example loss and accuracy by task.

Several ranks (`grid`, a `parallel.mesh.RankGrid` of an initialized
`torch.distributed` world; the port's counterpart of JAX's sharded step,
`rt1_tpu/trainer/train.py:234-266`). Each rank holds its block of the
global batch (ranks along `seq` share one) and runs the step by hand,
without `DistributedDataParallel` or `FullyShardedDataParallel`, which see
neither the functional call over the flat copy nor this Adam:

* The forward runs in `parallel.collectives.batch_shard`: BatchNorm's
  statistics are the global batch's, dropout and stochastic depth draw
  the global batch's masks and keep this rank's rows, and the MoE FFN
  routes the global batch (global capacity and queue order), so the ranks
  compute what the world of one computes on the global batch. The MoE
  load-balancing loss, a mean and not in the reference scale, enters each
  rank's loss as its part of the global loss times the divisor below.
* The flat float32 gradient is summed over the batch ranks (data x fsdp)
  and divided by W x extra, W the batch ranks: the reference loss scale
  makes a rank's loss on b/W rows W times its share of the global loss
  (extra = W; a family's mean loss, LAVA's MSE, needs extra = 1), the
  world-size form of the accumulation rule. The loss is reduced the same
  way; `moe_aux_loss` is the sum of the ranks' parts, `aux_mse` the mean
  over the ranks.
* fsdp > 1 is ZeRO-3 in JAX's schedule: the state holds 1/fsdp chunks of
  the masters and moments (`trainer/state.py::shard_train_state`); once a
  step the chunk is cast to the compute dtype and all-gathered into the
  flat compute copy (cast first: a bf16 gather moves half the bytes), the
  MoE routers' float32 masters are gathered too, the gradient is
  reduce-scattered into chunks (then all-reduced over data), and each
  rank updates its chunk.
* What decides or reports is global on every rank: the loss, the gradient
  norm (squared sums of the chunks all-reduced), hence clipping and the
  guard's verdict, `action_loss_mean` (in the reference scale, reduced as
  the loss) and the health pack. Every rank therefore applies or skips
  the same updates.
* Under tensor or pipeline parallelism (`parallel.tp`, `parallel.pp`) the
  state holds the rank's part of the policy (`parallel/partition.py`):
  its `model` slices and, under pp, its stage's layers, beside every whole
  leaf. Ranks along `model` and `stage` hold the same rows and compute the
  same loss, so the gradient is summed over the batch ranks only, as
  above: a sliced leaf's gradient is its slice's, a whole leaf's is the
  whole one on every rank (`parallel/tensor_parallel.py`,
  `parallel/pipeline.py`). The norms add the squared sums of sliced leaves
  over `model` and of stage-owned leaves over `stage`, and count whole
  leaves once (`StepComms.reduce_classes`), so clipping, the guard and the
  health pack read the world of one's numbers.

An initialized world of one runs the same collectives on one-rank groups
and computes the one-process step's numbers bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from rt1_tpu_torch.models.moe import router_names
from rt1_tpu_torch.obs.health import PACK_KEY, TASK_ID_KEY, HealthPack, leaf_lengths, param_paths
from rt1_tpu_torch.trainer.optim import Adam, AdamState, global_norm
from rt1_tpu_torch.trainer.state import TrainState

Batch = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]
RNG_STREAMS = ("crop", "dropout", "stochastic_depth", "augment")


def step_rngs(seed: int, step: int, device, micro: int = 0,
              augment: bool = False, crop_on_host: bool = False) -> Dict[str, torch.Generator]:
    """One generator per random stream on `device` (the crop's on the host
    with `crop_on_host`), seeded from (seed, step, stream index, micro);
    the `augment` stream only when `augment` (its index is the last, so
    the others' seeds do not depend on it)."""
    device = torch.device(device)
    rngs = {}
    for index, name in enumerate(RNG_STREAMS):
        if name == "augment" and not augment:
            continue
        words = np.random.SeedSequence([seed, step, index, micro]).generate_state(2, np.uint32)
        g = torch.Generator(device="cpu" if crop_on_host and name == "crop" else device)
        g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
        rngs[name] = g
    return rngs


def _strip_task_ids(obs: Dict[str, torch.Tensor]):
    """(observations without the task ids, the ids or None)."""
    if TASK_ID_KEY not in obs:
        return obs, None
    obs = dict(obs)
    return obs, obs.pop(TASK_ID_KEY)


def _split(batch: Batch, parts: int):
    obs, actions = batch
    b = next(iter(obs.values())).shape[0]
    if b % parts:
        raise ValueError(f"batch {b} is not divisible by accum_steps={parts}")
    cut = lambda tree, i: {k: v.chunk(parts)[i] for k, v in tree.items()}  # noqa: E731
    return [(cut(obs, i), cut(actions, i)) for i in range(parts)]


@dataclasses.dataclass
class TrainStepFns:
    optimizer: Adam
    seed: int
    compute_dtype: torch.dtype = torch.float32
    accum_steps: int = 1
    guard_nonfinite: bool = False
    guard_grad_norm_max: float = 0.0
    model_health: bool = False
    health_group_depth: int = 2
    health_task_names: Tuple[str, ...] = ()
    photometric_augmentation: bool = False
    # The MoE FFN's load-balancing loss (the policy's "moe_aux_loss", the
    # mean over layers) enters the train loss at this weight.
    moe_aux_weight: float = 0.01
    # parallel.mixed_precision: every leaf, the routers too, computes from
    # its bf16 copy (JAX's `_bf16_compute_copy`).
    mixed_precision: bool = False
    # Draw the crop's two offsets on the host whatever the step's device
    # (module docstring, "Randomness").
    crop_on_host: bool = False
    # Another family's loss (`trainer/bc.py::make_bc_step_loss_fn`):
    # (policy, params, obs, actions, train, rngs) -> {"loss", ...}.
    loss_fn: Optional[Callable] = None
    # The rank grid of a multi-process run (`parallel.mesh.RankGrid`); None
    # or a grid without a process group is the one-process step.
    grid: Optional[Any] = None
    _health: Optional[HealthPack] = dataclasses.field(default=None, init=False, repr=False)
    _comms: Optional[Any] = dataclasses.field(default=None, init=False, repr=False)
    _classes: Optional[Any] = dataclasses.field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {self.accum_steps}")
        if self.grid is not None and self.grid.distributed:
            from rt1_tpu_torch.parallel.collectives import StepComms

            self._comms = StepComms(self.grid)

    def _loss_divisor(self) -> float:
        """W x extra (see the module docstring); 1 without ranks."""
        if self._comms is None:
            return 1.0
        ways = float(self._comms.ways)
        return ways * (ways if self.loss_fn is None else 1.0)

    def _forward_context(self):
        return self._comms.forward_context() if self._comms is not None \
            else contextlib.nullcontext()

    def _health_pack(self, state: TrainState) -> HealthPack:
        """The pack of `state`'s layout, built at first use. Action
        statistics need the unaccumulated step's logits, as in JAX."""
        if self._health is None:
            rt1 = self.accum_steps == 1 and self.loss_fn is None
            action_dims = state.policy.tokens_per_action if rt1 else 0
            chunk = (state.shard.lo, state.shard.hi) if state.shard is not None else None
            partition = state.partition
            self._health = HealthPack(
                param_paths(state.policy), state.layout.padded, state.flat.device,
                depth=self.health_group_depth, action_dims=action_dims,
                task_names=self.health_task_names, chunk=chunk,
                groups_of=partition.paths if partition is not None else None,
                classes=[partition.leaf_class(n) for n in state.names] + [0] * (chunk is not None)
                if partition is not None else None)
        return self._health

    def health_names(self, state: TrainState) -> Tuple[str, ...]:
        """The entry names of the pack (empty with `model_health` off)."""
        return self._health_pack(state).names if self.model_health else ()

    def _compute_copy(self, state: TrainState, requires_grad: bool):
        """(the flat compute copy of the masters, its views by name, the
        float32 copies of the MoE routers by parameter index). The routers keep
        float32 weights unless mixed precision casts every leaf, as JAX's
        modules keep a `dtype=float32` Dense's params. Under fsdp the copy is
        the all-gather of every rank's chunk, cast first."""
        if state.shard is None:
            copy = state.flat.detach().to(self.compute_dtype, copy=True)
        else:
            copy = self._comms.gather_flat(state.flat.detach().to(self.compute_dtype),
                                           state.shard.size)
        copy.requires_grad_(requires_grad)
        views = state.layout.views(copy[:state.layout.size])
        kept = {}
        if self.compute_dtype != torch.float32 and not self.mixed_precision:
            routers = set(router_names(state.policy))
            indices = [i for i, name in enumerate(state.names) if name in routers]
            for i, master in self._float32_masters(state, indices).items():
                kept[i] = master.detach().clone().requires_grad_(requires_grad)
                views[i] = kept[i]
        return copy, dict(zip(state.names, views)), kept

    def _float32_masters(self, state: TrainState, indices) -> Dict[int, torch.Tensor]:
        """The whole float32 masters of the parameters `indices`: views of
        `state.flat`, or under fsdp the sum over the fsdp ranks of each
        rank's part of them (the parts are disjoint: a gather)."""
        if not indices:
            return {}
        layout = state.layout
        if state.shard is None:
            masters = layout.views(state.flat)
            return {i: masters[i] for i in indices}
        shard = state.shard
        offsets = np.concatenate([[0], np.cumsum(layout.padded)])
        pieces = []
        for i in indices:
            start, n = int(offsets[i]), layout.numels[i]
            piece = torch.zeros(n, dtype=torch.float32, device=state.flat.device)
            lo, hi = max(start, shard.lo), min(start + n, shard.hi)
            if lo < hi:
                piece[lo - start:hi - start] = state.flat[lo - shard.lo:hi - shard.lo]
            pieces.append(piece)
        whole = self._comms.sum_shards(torch.cat(pieces))
        parts = whole.split([layout.numels[i] for i in indices])
        return {i: p.view(layout.shapes[i]) for i, p in zip(indices, parts)}

    def _grad(self, state: TrainState, batch: Batch, rngs: Mapping[str, torch.Generator]):
        """Loss, float32 flat gradient and aux dict of one (micro-)batch."""
        copy, params, kept = self._compute_copy(state, requires_grad=True)
        obs, actions = batch
        obs, task_ids = _strip_task_ids(obs)
        with self._forward_context():
            out = self.forward(state.policy, params, obs, actions, rngs)
        grads = torch.autograd.grad(out["loss"], [copy, *kept.values()])
        grad = grads[0].to(torch.float32)
        if kept:
            grad_views = state.layout.views(grad[:state.layout.size])
            for i, g in zip(kept, grads[1:]):
                grad_views[i].copy_(g)
        out = {k: v.detach() for k, v in out.items()}
        if task_ids is not None and self.health_task_names:
            out["task_ids"] = task_ids
        return out["loss"], grad, out

    def forward(self, policy, params, obs, actions, rngs) -> Dict[str, torch.Tensor]:
        """The train-mode loss dict of `policy` at `params`: the RT-1
        policy's, whose MoE load-balancing loss joins the loss here (train
        only: the eval loss stays the task loss), or the `loss_fn` of
        another family."""
        if self.loss_fn is not None:
            return self.loss_fn(policy, params, obs, actions, True, rngs)
        out = torch.func.functional_call(policy, params, (obs, actions),
                                         {"train": True, "rngs": rngs})
        if "moe_aux_loss" in out:
            # With ranks, "moe_aux_loss" is this rank's part of the global
            # load-balancing loss (`models/moe.py`): times the divisor, it
            # keeps its weight through the step's sum over ranks / divisor.
            weight = self.moe_aux_weight * self._loss_divisor()
            out = dict(out, loss=out["loss"] + weight * out["moe_aux_loss"])
        return out

    def value_and_grad(self, state: TrainState, batch: Batch, step: int):
        """(loss, flat float32 gradient, aux dict) of the train-mode loss at
        the current masters, accumulated over `accum_steps` micro-batches;
        the BatchNorm statistics advance as in a step. With ranks, the
        global loss and gradient (this rank's chunk of it under fsdp) and
        the monitors' means over the ranks. `grads_by_name` unflattens a
        whole gradient."""
        loss, grad, out = self._local_value_and_grad(state, batch, step)
        comms = self._comms
        if comms is None:
            return loss, grad, out
        divisor = self._loss_divisor()
        grad = comms.reduce_grad(grad, state.shard) / divisor
        loss = comms.sum_rows(loss) / divisor
        out = dict(out, loss=loss)
        if "aux_mse" in out:
            out["aux_mse"] = comms.mean_rows(out["aux_mse"])
        if "moe_aux_loss" in out:  # the ranks' parts of the global loss
            out["moe_aux_loss"] = comms.sum_rows(out["moe_aux_loss"])
        return loss, grad, out

    def _local_value_and_grad(self, state: TrainState, batch: Batch, step: int):
        """`value_and_grad` of this rank's rows alone."""
        device = state.flat.device
        streams = {"augment": self.photometric_augmentation, "crop_on_host": self.crop_on_host}
        if self.accum_steps == 1:
            return self._grad(state, batch, step_rngs(self.seed, step, device, **streams))
        # The reference loss scale makes a micro-batch's loss accum times
        # the full batch's: the extra /accum. Another family's mean loss
        # (LAVA's MSE) needs none, as in JAX.
        extra = float(self.accum_steps) if self.loss_fn is None else 1.0
        grad, loss, mse, moe = None, 0.0, 0.0, 0.0
        for i, micro in enumerate(_split(batch, self.accum_steps)):
            l_i, g_i, out_i = self._grad(state, micro,
                                         step_rngs(self.seed, step, device, micro=i + 1,
                                                   **streams))
            grad = g_i if grad is None else grad + g_i
            loss = loss + l_i
            mse = mse + out_i.get("aux_mse", 0.0)
            moe = moe + out_i.get("moe_aux_loss", 0.0)
        grad = grad / (self.accum_steps * extra)
        loss = loss / (self.accum_steps * extra)
        out = {"loss": loss}
        # The monitors are means over the micro-batches.
        if "aux_mse" in out_i:
            out["aux_mse"] = mse / self.accum_steps
        if "moe_aux_loss" in out_i:
            out["moe_aux_loss"] = moe / self.accum_steps
        return loss, grad, out

    def grad_norm(self, state: TrainState, grad: torch.Tensor) -> torch.Tensor:
        """The global norm of the (reduced) gradient: of its chunks' squared
        sums summed over the fsdp ranks under fsdp; under tp or pp, each
        leaf class's squared sum over its axes (module docstring)."""
        if state.partition is not None:
            if self._classes is None:
                chunk = (state.shard.lo, state.shard.hi) if state.shard is not None else None
                lengths = leaf_lengths(state.layout.padded, chunk)
                classes = torch.zeros((len(lengths), 4), dtype=torch.float64)
                for leaf, name in enumerate(state.names):
                    classes[leaf, state.partition.leaf_class(name)] = 1.0
                self._classes = (torch.tensor(lengths, dtype=torch.int64, device=grad.device),
                                 classes.to(grad.device))
            lengths, classes = self._classes
            # float64: `segment_reduce` sums a segment in order on the CPU
            # (1e-3 relative error over 2M float32 squares).
            per_leaf = torch.segment_reduce(torch.square(grad.double()), "sum", lengths=lengths,
                                            initial=0.0)
            sumsq = self._comms.reduce_classes(per_leaf @ classes)
            return torch.sqrt(sumsq).to(torch.float32)
        if state.shard is None:
            return global_norm(grad)
        return torch.sqrt(self._comms.sum_shards(torch.sum(torch.square(grad))))

    @staticmethod
    def grads_by_name(state: TrainState, grad: torch.Tensor) -> Dict[str, torch.Tensor]:
        return dict(zip(state.names, state.layout.views(grad)))

    def train_step(self, state: TrainState, batch: Batch, step: int,
                   keep_grad: bool = False) -> Dict[str, torch.Tensor]:
        """One optimizer update on `batch`, in place; `step` is the loop's
        step (it seeds the generators). Returns device metrics, and the flat
        gradient under "grad" with `keep_grad`."""
        if self.guard_nonfinite:
            old_buffers = state.flat_buffers.clone()
        loss, grad, out = self.value_and_grad(state, batch, step)
        grad_norm = self.grad_norm(state, grad)
        # Clipping reads the global norm (a ZeRO-3 chunk's own is not).
        new_flat, new_opt = self.optimizer.update(grad, state.opt_state, state.flat,
                                                  grad_norm=grad_norm)
        metrics = {"loss": loss, "grad_norm": grad_norm}
        if keep_grad:
            metrics["grad"] = grad
        if "action_loss" in out:
            metrics["action_loss_mean"] = out["action_loss"].mean()
            if self._comms is not None:  # in the reference scale, as the loss
                metrics["action_loss_mean"] = self._comms.sum_rows(
                    metrics["action_loss_mean"]) / self._loss_divisor()
        if "aux_mse" in out:
            metrics["aux_mse"] = out["aux_mse"]
        if "moe_aux_loss" in out:  # the routing-collapse monitor
            metrics["moe_aux_loss"] = out["moe_aux_loss"]
        if self.model_health:
            metrics[PACK_KEY] = self._health_pack(state).compute(
                grad, new_flat - state.flat, new_flat, out, comms=self._comms)
        if self.guard_nonfinite:
            ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
            if self.guard_grad_norm_max > 0:
                ok &= grad_norm <= self.guard_grad_norm_max
            new_flat = torch.where(ok, new_flat, state.flat)
            new_opt = AdamState(
                count=torch.where(ok, new_opt.count, state.opt_state.count),
                mu=torch.where(ok, new_opt.mu, state.opt_state.mu),
                nu=torch.where(ok, new_opt.nu, state.opt_state.nu),
            )
            state.flat_buffers.copy_(torch.where(ok, state.flat_buffers, old_buffers))
            state.step += ok.to(torch.int64)
            state.guard_skips += (~ok).to(torch.int64)
            metrics["guard_skips_cum"] = state.guard_skips.clone()
        else:
            state.step += 1
        state.flat.copy_(new_flat)
        state.opt_state = new_opt
        return metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        """Eval-mode loss and token accuracy on `batch` (no update)."""
        _, params, _ = self._compute_copy(state, requires_grad=False)
        obs, actions = batch
        obs, _ = _strip_task_ids(obs)
        if self.loss_fn is not None:
            with self._forward_context():
                out = {"loss": self.loss_fn(state.policy, params, obs, actions, False,
                                            None)["loss"]}
        else:
            with self._forward_context():  # the MoE routes the global batch
                result = torch.func.functional_call(state.policy, params, (obs, actions),
                                                    {"train": False})
            labels, preds = result["action_labels"], result["action_predictions"]
            out = {"loss": result["loss"],
                   "token_accuracy": (preds == labels).to(torch.float32).mean()}
        if self._comms is not None:  # the global batch's, as the train loss
            out["loss"] = self._comms.sum_rows(out["loss"]) / self._loss_divisor()
            if "token_accuracy" in out:
                out["token_accuracy"] = self._comms.mean_rows(out["token_accuracy"])
        return out


def optimizer_from_config(config) -> Adam:
    return Adam(
        learning_rate=config.learning_rate,
        milestones=config.lr_milestones,
        gamma=config.lr_gamma,
        steps_per_epoch=config.steps_per_epoch,
        grad_clip_norm=config.grad_clip_norm or None,
        weight_decay=config.weight_decay,
    )


def train_step_fns_from_config(config, optimizer: Optional[Adam] = None,
                               health_task_names: Tuple[str, ...] = (),
                               grid: Optional[Any] = None) -> TrainStepFns:
    """The steps `config` describes. Compute in bf16 when the model does or
    mixed precision is on (which forces bf16 compute, as in JAX); the LAVA
    family computes in float32 on `trainer/bc.py`'s loss.
    `health_task_names` are the feeder's, when it emits task ids; `grid`
    the rank grid of a multi-process run."""
    bf16 = config.parallel.mixed_precision or config.model.dtype == "bfloat16"
    loss_fn = None
    if config.model.family == "lava":
        # LAVA computes in float32 (it has no dtype field) on its MSE loss.
        from rt1_tpu_torch.trainer.bc import make_bc_step_loss_fn

        bf16, loss_fn = False, make_bc_step_loss_fn()
    return TrainStepFns(
        optimizer or optimizer_from_config(config),
        seed=config.seed,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        accum_steps=config.accum_steps,
        guard_nonfinite=config.resilience.guard,
        guard_grad_norm_max=config.resilience.guard_grad_norm_max,
        model_health=config.obs.model_health,
        health_group_depth=config.obs.health_group_depth,
        health_task_names=tuple(health_task_names),
        photometric_augmentation=config.model.photometric_augmentation,
        moe_aux_weight=config.model.moe_aux_weight,
        mixed_precision=config.parallel.mixed_precision,
        loss_fn=loss_fn,
        grid=grid,
    )
