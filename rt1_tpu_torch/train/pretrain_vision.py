"""Vision pretraining by block-state regression on simulator frames
(counterpart of `rt1_tpu/train/pretrain_vision.py`).

The reference starts its image tower from ImageNet EfficientNet-B3 weights,
which this repository does not hold. The simulator gives unlimited (frame,
effector and block positions) pairs for free, so the encoder is pretrained
on state regression, the visual skill the policy needs, and grafted into
the RT-1 tokenizer as its initialisation. The attainable position error
also measures what a given encoder and resolution can resolve.

`VisionPretrainModel` is the tokenizer's `EfficientNetEncoder` (the same
module tree: `encoder.net`, `encoder.conv1x1`, `encoder.film`) with a zero
FiLM context, mean-pooled, and a linear head; `graft_encoder_into_policy`
copies its encoder into a policy's tokenizer, shape-checked leaf by leaf.
The port saves the encoder with `torch.save` plus the metrics JSON sidecar;
`load_encoder` reads those and the JAX package's flax msgpack files alike
(`utils/flax_msgpack.py`).
Frames are resized with the native sampler where JAX uses `cv2.resize`.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from rt1_tpu_torch import resolve_device
from rt1_tpu_torch.convert import init_weights
from rt1_tpu_torch.models.encoder import EfficientNetEncoder
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import FlatLayout
from rt1_tpu_torch.trainer.train import step_rngs

ENCODER_FORMAT = "rt1_tpu_torch.pretrained_encoder/1"
FLAX_ENCODER_FORMAT = "flax_msgpack"  # `load_encoder` of a JAX package's encoder
CONTEXT_DIM = 512
_RESIZE_CHUNK = 256  # frames resized at a time


def generate_state_regression_dataset(num_frames: int, block_mode: str = "BLOCK_4", seed: int = 0,
                                      image_hw=(64, 96), random_steps: int = 8,
                                      reward_name: str = "block2block"):
    """Render `num_frames` frames with their effector and block positions.

    Each sample resets to a random board, takes U[0, random_steps] uniform
    random effector actions, then records (the frame resized to
    `image_hw`, [effector_xy, block_xy...]). Returns (images uint8
    (N, H, W, 3), targets float32 (N, D), target names).
    """
    from rt1_tpu_torch.data.collect import resize_frames
    from rt1_tpu_torch.envs import blocks, rewards
    from rt1_tpu_torch.envs.language_table import LanguageTable

    env = LanguageTable(block_mode=blocks.BlockMode(block_mode),
                        reward_factory=rewards.get_reward_factory(reward_name), seed=seed)
    rng = np.random.default_rng(seed)
    images, frames, targets = [], [], []
    target_names: Optional[list] = None
    while len(targets) < num_frames:
        env.reset()
        for _ in range(int(rng.integers(0, random_steps + 1))):
            env.step(rng.uniform(-0.03, 0.03, size=2).astype(np.float32))
        state = env.compute_state(request_task_update=False)
        block_keys = sorted(k for k in state
                            if k.startswith("block_") and k.endswith("_translation"))
        if target_names is None:
            target_names = ["effector_x", "effector_y"] + [
                f"{k}_{ax}" for k in block_keys for ax in ("x", "y")]
        targets.append(np.concatenate(
            [np.asarray(state["effector_translation"], np.float32)]
            + [np.asarray(state[k], np.float32) for k in block_keys]))
        frames.append(np.array(state["rgb"], np.uint8))
        if len(frames) == _RESIZE_CHUNK:
            images.append(resize_frames(frames, image_hw))
            frames = []
    if frames:
        images.append(resize_frames(frames, image_hw))
    return np.concatenate(images), np.stack(targets), target_names


class VisionPretrainModel(nn.Module):
    """`EfficientNetEncoder` (the tokenizer's submodule) + a regression head.
    The FiLM context is zeros: the FiLM projections start at zero, so the
    grafted encoder behaves the same until language conditioning trains."""

    def __init__(self, target_dim: int, token_embedding_size: int = 512,
                 width_coefficient: float = 0.35, depth_coefficient: float = 0.35,
                 drop_connect_rate: float = 0.2):
        super().__init__()
        self.width_coefficient = width_coefficient
        self.depth_coefficient = depth_coefficient
        self.token_embedding_size = token_embedding_size
        self.encoder = EfficientNetEncoder(
            token_embedding_size=token_embedding_size, early_film=True,
            width_coefficient=width_coefficient, depth_coefficient=depth_coefficient,
            context_dim=CONTEXT_DIM, drop_connect_rate=drop_connect_rate)
        self.head = nn.Linear(token_embedding_size, target_dim)

    def forward(self, images: torch.Tensor, train: bool = False, rngs=None) -> torch.Tensor:
        """images: (B, H, W, 3) uint8 or [0, 255] floats. Returns (B, D)."""
        x = images.to(torch.float32) / 255.0  # the ops/image.py convention
        context = torch.zeros((x.shape[0], CONTEXT_DIM), dtype=x.dtype, device=x.device)
        feats = self.encoder(x, context=context, train=train, rngs=rngs)
        return self.head(feats.mean(dim=(1, 2)))


def pretrain_encoder(
    images: np.ndarray,
    targets: np.ndarray,
    *,
    num_steps: int = 3000,
    batch_size: int = 32,
    learning_rate: float = 1e-3,
    val_fraction: float = 0.1,
    seed: int = 0,
    width_coefficient: float = 0.35,
    depth_coefficient: float = 0.35,
    token_embedding_size: int = 512,
    eval_every: int = 500,
    log: Callable = print,
    device=None,
    drop_connect_rate: float = 0.2,
    initial_state=None,
    step_times: Optional[list] = None,
):
    """Train the probe; returns (model, metrics).

    Targets are standardised per dimension (mean and std in the metrics);
    `val_rmse` is de-standardised, in board units (metres). Adam at a
    constant `learning_rate` (optax's rule, `trainer/optim.py`), BatchNorm
    in train mode, stochastic depth from per-step generators seeded by
    `seed`; batches drawn as the JAX function draws them
    (`default_rng(seed).integers`). The model starts from `initial_state`
    (a state_dict) when given, else from the port's init seeded by `seed`.
    Runs on `cuda` unless `device` says otherwise. `step_times`, a list if
    given, receives each step's wall time in ms (synchronised).
    """
    dev = resolve_device(device)
    n_val = max(1, int(len(images) * val_fraction))
    train_x, val_x = images[n_val:], images[:n_val]
    train_y, val_y = targets[n_val:], targets[:n_val]
    mu = train_y.mean(axis=0)
    sd = train_y.std(axis=0) + 1e-8
    train_yn = (train_y - mu) / sd

    model = VisionPretrainModel(targets.shape[1], token_embedding_size=token_embedding_size,
                                width_coefficient=width_coefficient,
                                depth_coefficient=depth_coefficient,
                                drop_connect_rate=drop_connect_rate)
    if initial_state is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(initial_state)
    model.to(dev)
    params = list(model.parameters())
    layout = FlatLayout(params)
    flat = layout.adopt(params)  # the parameters become views of `flat`
    optimizer = Adam(learning_rate, milestones=())
    opt_state = optimizer.init(flat)

    def val_rmse():
        preds = []
        with torch.no_grad():
            for i in range(0, len(val_x), batch_size):
                bx = torch.from_numpy(val_x[i:i + batch_size]).to(dev)
                preds.append(model(bx, train=False).cpu().numpy())
        preds = np.concatenate(preds) * sd + mu
        return float(np.sqrt(np.mean((preds - val_y) ** 2)))

    data_rng = np.random.default_rng(seed)
    history = []
    for step in range(num_steps):
        t0 = time.perf_counter()
        idx = data_rng.integers(0, len(train_x), batch_size)
        bx = torch.from_numpy(train_x[idx]).to(dev)
        by = torch.from_numpy(train_yn[idx]).to(dev)
        for p in params:
            p.grad = None
        out = model(bx, train=True, rngs=step_rngs(seed, step, dev))
        loss = torch.mean((out - by) ** 2)
        loss.backward()
        grads = layout.flatten([p.grad for p in params])
        with torch.no_grad():
            new_flat, opt_state = optimizer.update(grads, opt_state, flat)
            flat.copy_(new_flat)
        if step_times is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_times.append((time.perf_counter() - t0) * 1e3)
        if step % eval_every == 0 or step == num_steps - 1:
            rmse = val_rmse()
            loss_value = float(loss.detach())
            history.append({"step": step, "train_loss": loss_value, "val_rmse": rmse})
            log(f"pretrain step {step}: loss {loss_value:.4f} val_rmse {rmse * 1000:.2f} mm")
    for p in params:
        p.grad = None
    metrics = {
        "val_rmse": history[-1]["val_rmse"],
        "val_rmse_mm": history[-1]["val_rmse"] * 1000.0,
        "history": history,
        "target_mean": mu.tolist(),
        "target_std": sd.tolist(),
        "num_train_frames": int(len(train_x)),
        "num_val_frames": int(len(val_x)),
    }
    return model, metrics


def save_encoder(model: VisionPretrainModel, metrics, path: str) -> None:
    """Write the encoder's state_dict (`torch.save`, with its coefficients)
    to `path` and the metrics to `path + ".json"`."""
    torch.save({
        "format": ENCODER_FORMAT,
        "width_coefficient": float(model.width_coefficient),
        "depth_coefficient": float(model.depth_coefficient),
        "token_embedding_size": int(model.token_embedding_size),
        "state_dict": {k: v.detach().cpu() for k, v in model.encoder.state_dict().items()},
    }, path)
    with open(path + ".json", "w") as f:
        json.dump({k: v for k, v in metrics.items() if k != "history"}
                  | {"history": metrics.get("history", [])}, f, indent=2)


def load_encoder(path: str) -> dict:
    """Inverse of `save_encoder`: the saved dict, tensors on the CPU. A
    JAX package's encoder (flax msgpack of {"params", "batch_stats"}, its
    `save_encoder`) comes back as {"format": FLAX_ENCODER_FORMAT,
    "state_dict"} with the leaves converted to the port's layout
    (`convert.state_dict_from_flax`); either dict grafts as it is."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != b"PK\x03\x04":  # not a torch.save zip: flax msgpack
        from rt1_tpu_torch.convert import state_dict_from_flax
        from rt1_tpu_torch.utils import flax_msgpack

        with open(path, "rb") as f:
            tree = flax_msgpack.restore(f.read())
        if not isinstance(tree, dict) or "params" not in tree:
            raise ValueError(f"{path} is neither a {ENCODER_FORMAT} file nor a flax encoder")
        return {"format": FLAX_ENCODER_FORMAT,
                "state_dict": state_dict_from_flax(tree["params"], tree.get("batch_stats"))}
    encoder = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(encoder, dict) or encoder.get("format") != ENCODER_FORMAT:
        raise ValueError(f"{path} is not a {ENCODER_FORMAT} file")
    return encoder


def graft_encoder_into_policy(policy: nn.Module, encoder, tokenizer_name: Optional[str] = None):
    """Copy a pretrained encoder (`load_encoder`'s dict, or an encoder
    state_dict) into the policy's image tokenizer, in place; returns the
    policy.

    Every leaf is checked: the key sets must be equal and each shape equal
    (a resolution change is fine, the encoder is convolutional; a width or
    depth coefficient mismatch raises ValueError rather than graft part of
    the tree). `tokenizer_name` defaults to the one child of the policy
    that holds an `EfficientNetEncoder` as `encoder`.
    """
    state = encoder["state_dict"] if "state_dict" in encoder else encoder
    if tokenizer_name is None:
        candidates = [name for name, child in policy.named_children()
                      if isinstance(getattr(child, "encoder", None), EfficientNetEncoder)]
        if len(candidates) != 1:
            raise ValueError(f"could not locate the image tokenizer (children with an "
                             f"EfficientNetEncoder 'encoder': {candidates}); pass tokenizer_name")
        tokenizer_name = candidates[0]
    target = getattr(policy, tokenizer_name).encoder.state_dict()
    if set(target) != set(state):
        differing = sorted(set(target) ^ set(state))
        raise ValueError(f"pretrained encoder tree mismatch (differing keys: {differing[:4]}...): "
                         "was it trained with the same width/depth coefficients?")
    for key, dst in target.items():
        if tuple(dst.shape) != tuple(state[key].shape):
            raise ValueError(f"pretrained encoder shape mismatch at {key}: checkpoint "
                             f"{tuple(state[key].shape)} vs model {tuple(dst.shape)}")
    with torch.no_grad():
        for key, dst in target.items():
            dst.copy_(state[key].to(dtype=dst.dtype))
    return policy
