"""MSE behavioural-cloning loss and optimizer freezing for the LAVA family
(counterpart of `rt1_tpu/trainer/bc.py`).

Parity source: reference `language_table/train/bc.py`:

* `bc_mse_loss` (`:206-234`): MSE between predicted and target actions,
  in normalised action space when statistics are given;
* `make_bc_optimizer` (`:119-140`): Adam(eps=1e-7) whose frozen
  parameters (state_dict prefixes, whole path segments) get zero updates,
  as `optax.multi_transform` with `set_to_zero` gives them;
* `remap_pretrained_params` (`:94-110`): pretrained tensors copied under
  new key prefixes.

`make_bc_step_loss_fn` is the train step's loss for the LAVA family
(`trainer/train.py::TrainStepFns.loss_fn`): the windowed batch's `image`
becomes `rgb` in [0, 1] (`adapt_obs_for_lava`), and the target is the
LAST frame's action (LAVA predicts one action a window). The frozen
ResNet's BatchNorm never updates, so the statistics pass through.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from rt1_tpu_torch.ops.image import convert_dtype
from rt1_tpu_torch.trainer.optim import Adam, AdamState


def bc_mse_loss(predicted: torch.Tensor, target: torch.Tensor,
                norm_mean: Optional[torch.Tensor] = None,
                norm_std: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-squared BC loss, optionally in normalised action space."""
    if norm_mean is not None and norm_std is not None:
        target = (target - norm_mean) / (norm_std + 1e-8)
    return torch.mean(torch.square(predicted - target))


def _dotted(prefix: str) -> str:
    return prefix.replace("/", ".")


def is_frozen(name: str, frozen_prefixes: Sequence[str]) -> bool:
    """Whether state_dict key `name` lies under one of the prefixes
    (whole segments: "enc.conv" does not freeze "enc.conv_extra"; '/'
    separators, JAX's, are accepted)."""
    return any(name == p or name.startswith(p + ".") for p in map(_dotted, frozen_prefixes))


class FrozenAdam(Adam):
    """Adam whose parameters under `frozen_prefixes` never move. The train
    state calls `bind` with its layout before `init`."""

    def __init__(self, frozen_prefixes: Sequence[str] = (), **kwargs):
        super().__init__(**kwargs)
        self.frozen_prefixes = tuple(frozen_prefixes)
        self.trainable: Optional[torch.Tensor] = None

    def bind(self, names: Sequence[str], layout, device) -> None:
        """The flat trainable mask of a state whose parameters are `names`
        laid out by `layout`."""
        mask = torch.zeros(layout.size, dtype=torch.bool, device=device)
        for view, name in zip(layout.views(mask), names):
            view.fill_(not is_frozen(name, self.frozen_prefixes))
        self.trainable = mask

    def take_shard(self, shard) -> None:
        """Keep the mask of chunk `shard` (`trainer/state.py::FlatShard`) of
        the layout, for a ZeRO-3 state's chunk."""
        if self.trainable is not None:
            self.trainable = shard.take(self.trainable.to(torch.uint8)).bool()

    def update(self, grads: torch.Tensor, state: AdamState, params: torch.Tensor,
               grad_norm: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, AdamState]:
        new, new_state = super().update(grads, state, params, grad_norm=grad_norm)
        if self.frozen_prefixes:
            if self.trainable is None:
                raise ValueError("FrozenAdam.bind(names, layout, device) was not called")
            new = torch.where(self.trainable, new, params)
        return new, new_state


def make_bc_optimizer(learning_rate: float = 1e-3, eps: float = 1e-7,
                      frozen_prefixes: Sequence[str] = ()) -> FrozenAdam:
    """Adam at a constant `learning_rate` with optional frozen subtrees
    (state_dict prefixes, e.g. `clip_text.FROZEN_PREFIX`)."""
    return FrozenAdam(frozen_prefixes, learning_rate=learning_rate, milestones=(), eps=eps)


def remap_pretrained_params(params: Mapping[str, torch.Tensor],
                            pretrained: Mapping[str, torch.Tensor],
                            prefix_map: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """Copy pretrained tensors into `params` (a state_dict) under new key
    prefixes. `prefix_map`: {pretrained_prefix: target_prefix} ('.' or '/'
    separated). Keys not covered keep their values; a target key the
    params lack raises KeyError, a shape mismatch ValueError, and a prefix
    that matches nothing KeyError."""
    out = dict(params)
    for src_prefix, dst_prefix in prefix_map.items():
        src_prefix, dst_prefix = _dotted(src_prefix), _dotted(dst_prefix)
        hits = 0
        for key, value in pretrained.items():
            if not key.startswith(src_prefix):
                continue
            dst = dst_prefix + key[len(src_prefix):]
            if dst not in out:
                raise KeyError(f"Remap target {dst!r} not present in params")
            if tuple(out[dst].shape) != tuple(value.shape):
                raise ValueError(f"Shape mismatch at {dst!r}: {tuple(out[dst].shape)} vs "
                                 f"{tuple(value.shape)}")
            out[dst] = value
            hits += 1
        if hits == 0:
            raise KeyError(f"No pretrained params matched prefix {src_prefix!r}")
    return out


def adapt_obs_for_lava(obs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Windowed-pipeline observations -> LAVA's: `image` renamed `rgb` and
    taken from the wire dtype (uint8) to [0, 1] float32."""
    lava_obs = dict(obs)
    if "rgb" not in lava_obs and "image" in lava_obs:
        lava_obs["rgb"] = lava_obs.pop("image")
    if "rgb" in lava_obs:
        lava_obs["rgb"] = convert_dtype(lava_obs["rgb"])
    return lava_obs


def _target(actions) -> torch.Tensor:
    target = actions["action"] if isinstance(actions, Mapping) else actions
    return target[:, -1] if target.dim() == 3 else target


def make_bc_step_loss_fn() -> Callable:
    """The LAVA family's loss in the train step's signature
    `(policy, params, obs, actions, train, rngs) -> {"loss"}`: the policy
    run through `functional_call` on `params` (dropout from `rngs` in
    train mode), MSE against the last frame's action."""

    def loss_fn(policy, params, obs, actions, train, rngs):
        predicted = torch.func.functional_call(policy, params, (adapt_obs_for_lava(obs),),
                                               {"train": train, "rngs": rngs if train else None})
        return {"loss": bc_mse_loss(predicted, _target(actions).to(predicted.dtype))}

    return loss_fn


def make_bc_loss_fn(model: torch.nn.Module) -> Callable:
    """`(params, batch, rngs=None, train=True) -> (loss, {"loss"})` for an
    MSE-head model on already-adapted observations; `params` None runs
    the model's own tensors. The target is the raw (b, d) array or the
    last frame of `actions["action"]`."""

    def loss_fn(params, batch, rngs=None, train=True):
        obs, actions = batch
        kwargs = {"train": train, "rngs": rngs if train else None}
        if params is None:
            predicted = model(obs, **kwargs)
        else:
            predicted = torch.func.functional_call(model, params, (obs,), kwargs)
        loss = bc_mse_loss(predicted, _target(actions).to(predicted.dtype))
        return loss, {"loss": loss}

    return loss_fn
