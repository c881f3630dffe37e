"""The port's vision pretraining and encoder graft against the JAX package's.

Narrow coefficients (0.35/0.35, token width 16), 32x56 frames, float32.

* `VisionPretrainModel` forward on weights carried across by `convert.py`:
  within 1e-5 of max|out|, in eval mode (train mode: in
  `tests/test_torch_pretrain_graft.py`).
* One `pretrain_encoder` step from the JAX function's own initial variables
  (`model.init(PRNGKey(seed), ...)`, converted), stochastic depth off on
  both sides (JAX's `stochastic_depth` patched to the identity here; the
  port's `drop_connect_rate=0`), the same batch draw: the loss within 1e-5
  relative; each parameter within 1e-5 of the largest update wherever its
  gradient is at least 100 x Adam's eps (where it is smaller, Adam turns
  rounding noise into any update up to the learning rate, so there within
  2 lr, as `tests/test_torch_train_step.py` holds the train step); the
  BatchNorm statistics within 1e-5; `val_rmse` within 1e-4 relative.
* `generate_state_regression_dataset`: targets and names bitwise; images
  within 1/255 of cv2 on the frames the JAX renderer draws (these states'
  frames are drawn alike by both renderers).
* `save_encoder` / `load_encoder` round trip; a foreign file raises.

The graft and the trainer's graft hook are held in
`tests/test_torch_pretrain_graft.py`.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.models import efficientnet as jax_efficientnet
from rt1_tpu.train import pretrain_vision as jax_pv
from rt1_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.train import pretrain_vision as pv
from test_torch_modules import apply, randomized

torch.set_num_threads(2)

H, W = 32, 56
EMB = 16
COEFF = dict(width_coefficient=0.35, depth_coefficient=0.35)
# The step test's tower: one block a stage (7 blocks), so that the JAX
# side's two compiles (train step, eval) stay short.
STEP_COEFF = dict(width_coefficient=0.1, depth_coefficient=0.1)
TOL = 1e-5
EPS = 1e-8


_JAX_MODEL = jax_pv.VisionPretrainModel
_INITS = {}


class _JitInitModel(_JAX_MODEL):
    """The JAX model with `init` under jit (flax's eager init of the tower
    takes tens of seconds on one CPU core); jit draws the same numbers."""

    def init(self, rngs, x, train=False):
        key = (self.target_dim, self.token_embedding_size, self.width_coefficient,
               self.depth_coefficient, tuple(x.shape), train)
        if key not in _INITS:
            _INITS[key] = jax.jit(lambda r, v: _JAX_MODEL.init(self, r, v, train=train))
        return _INITS[key](rngs, x)


def _fake_data(n=12, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, H, W, 3), dtype=np.uint8),
            rng.normal(size=(n, dim)).astype(np.float32))


def _jax_model(target_dim=4, **coeff):
    return _JitInitModel(target_dim=target_dim, token_embedding_size=EMB, **(coeff or COEFF))


def _port_model(target_dim=4, drop_connect_rate=0.0):
    return pv.VisionPretrainModel(target_dim, token_embedding_size=EMB,
                                  drop_connect_rate=drop_connect_rate, **COEFF)


def _jax_variables(jm, seed):
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((2, H, W, 3)), train=False),
                            jax.random.PRNGKey(0))
    return randomized(shapes, seed)


def test_vision_pretrain_model_matches_jax(train=False):
    jm = _jax_model()
    variables = _jax_variables(jm, seed=3)
    images, _ = _fake_data(n=4)
    pm = _port_model()
    load_flax_variables(pm, variables["params"], variables["batch_stats"])
    if train:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_efficientnet, "stochastic_depth", lambda x, *a, **k: x)
            ref, _ = apply(jm, variables, jnp.asarray(images), train=True,
                           mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    else:
        ref = apply(jm, variables, jnp.asarray(images), train=False)
    out = pm(torch.from_numpy(images), train=train).detach().numpy()
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (4, 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL * float(np.abs(ref).max()))


def test_one_pretrain_step_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_efficientnet, "stochastic_depth", lambda x, *a, **k: x)
    monkeypatch.setattr(jax_pv, "VisionPretrainModel", _JitInitModel)
    images, targets = _fake_data()
    kwargs = dict(num_steps=1, batch_size=4, eval_every=1, seed=0, token_embedding_size=EMB,
                  learning_rate=1e-3, log=lambda *_: None, **STEP_COEFF)
    n_val = max(1, int(len(images) * 0.1))
    jm = _jax_model(**STEP_COEFF)
    init = jm.init(jax.random.PRNGKey(0), jnp.asarray(images[n_val:][:2]), train=False)
    init = jax.device_get(init)
    ref_vars, ref_metrics = jax_pv.pretrain_encoder(images, targets, **kwargs)
    initial = state_dict_from_flax(init["params"], init["batch_stats"])
    model, metrics = pv.pretrain_encoder(images, targets, device="cpu", drop_connect_rate=0.0,
                                         initial_state=initial, **kwargs)
    got, want = metrics["history"][0], ref_metrics["history"][0]
    assert got["step"] == want["step"] == 0
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=TOL)
    for key in ("target_mean", "target_std", "num_train_frames", "num_val_frames"):
        assert metrics[key] == ref_metrics[key], key

    # The first step's gradient, for the mask where Adam's eps decides.
    probe = pv.VisionPretrainModel(4, token_embedding_size=EMB, drop_connect_rate=0.0,
                                   **STEP_COEFF)
    probe.load_state_dict(initial)
    idx = np.random.default_rng(0).integers(0, len(images) - n_val, 4)
    mu, sd = targets[n_val:].mean(0), targets[n_val:].std(0) + 1e-8
    out = probe(torch.from_numpy(images[n_val:][idx]), train=True)
    torch.mean((out - torch.from_numpy((targets[n_val:][idx] - mu) / sd)) ** 2).backward()
    grads = {n: p.grad for n, p in probe.named_parameters()}
    floor = 1e-3 * max(float(g.abs().max()) for g in grads.values())

    after = state_dict_from_flax(jax.device_get(ref_vars["params"]),
                                 jax.device_get(ref_vars["batch_stats"]))
    own = model.state_dict()
    assert set(after) == set(own)
    largest = max(float((after[n] - initial[n]).abs().max()) for n in grads)
    assert 0 < largest <= 1e-3 * (1 + 1e-3)
    for name, value in after.items():
        diff = (own[name] - value).abs()
        if name in grads:
            solid = grads[name].abs() >= max(100 * EPS, floor)
            assert (diff[solid] <= TOL * largest).all(), (name, float(diff[solid].max()))
            assert (diff <= 2e-3 * (1 + 1e-3)).all(), (name, float(diff.max()))
        else:  # BatchNorm statistics
            assert (diff <= TOL).all(), (name, float(diff.max()))


def test_generate_state_regression_dataset_matches_jax():
    kwargs = dict(num_frames=6, seed=3, image_hw=(H, W), random_steps=2)
    images, targets, names = pv.generate_state_regression_dataset(**kwargs)
    ref_images, ref_targets, ref_names = jax_pv.generate_state_regression_dataset(**kwargs)
    assert names == ref_names and names[:2] == ["effector_x", "effector_y"]
    assert targets.dtype == ref_targets.dtype == np.float32
    assert targets.tobytes() == ref_targets.tobytes() and targets.shape == (6, 10)
    assert images.shape == ref_images.shape == (6, H, W, 3) and images.dtype == np.uint8
    diff = np.abs(images.astype(np.int32) - ref_images.astype(np.int32))
    assert diff.max() <= 1, int(diff.max())


def test_save_load_encoder_round_trip(tmp_path):
    images, targets = _fake_data()
    model, metrics = pv.pretrain_encoder(images, targets, num_steps=2, batch_size=4,
                                         eval_every=1, token_embedding_size=EMB, device="cpu",
                                         log=lambda *_: None, **COEFF)
    assert len(metrics["history"]) == 2 and np.isfinite(metrics["val_rmse"])
    assert metrics["val_rmse_mm"] == metrics["val_rmse"] * 1000.0
    path = str(tmp_path / "enc.pt")
    pv.save_encoder(model, metrics, path)
    enc = pv.load_encoder(path)
    assert (enc["width_coefficient"], enc["depth_coefficient"], enc["token_embedding_size"]) == \
        (0.35, 0.35, EMB)
    for key, value in model.encoder.state_dict().items():
        assert torch.equal(enc["state_dict"][key], value), key
    with open(path + ".json") as f:
        sidecar = json.load(f)
    assert sidecar["history"] == metrics["history"] and sidecar["val_rmse"] == metrics["val_rmse"]
    torch.save({"policy": {}}, str(tmp_path / "other.pt"))
    with pytest.raises(ValueError, match="not a"):
        pv.load_encoder(str(tmp_path / "other.pt"))
