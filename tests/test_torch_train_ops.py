"""The training slice's small pieces against the JAX package (or their law).

* `tokenize` and `continuous_targets`: exact, on values that straddle bin
  edges and the clip bounds.
* `random_shift_crop`: the output is a window of the zero-padded input,
  the offsets lie in [0, 2 * pad], every offset occurs, and one generator
  seed gives one output. With `crop_on_host` the train step's crop
  generator is a host one on every device (the masks' stay on the step's
  device), and the crop cuts images on another device than its
  generator's.
* Dropout: keep rate within 4.5 sigma, kept values scaled by 1 / (1 - rate),
  identity in eval mode or at rate 0, no generator in train mode raises.
* The LR schedule against `optax.piecewise_constant_schedule` (through the
  JAX package's `multistep_lr`) at every step around the milestones: equal
  in float32.
* The training config against the JAX config, and `--set` overrides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.models import action_tokenizer as jax_tokenizer
from rt1_tpu.specs import language_table_action_space as jax_action_space
from rt1_tpu.train.configs import language_table as jax_language_table
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.trainer.optim import multistep_lr as jax_multistep_lr
from rt1_tpu_torch.configs import apply_override, get_config
from rt1_tpu_torch.models import action_tokenizer
from rt1_tpu_torch.ops.dropout import dropout
from rt1_tpu_torch.ops.image import convert_dtype_and_crop_images, random_shift_crop
from rt1_tpu_torch.specs import language_table_action_space
from rt1_tpu_torch.trainer.optim import global_norm, multistep_lr
from rt1_tpu_torch.train.train import synthetic_batch
from rt1_tpu_torch.trainer.train import RNG_STREAMS, step_rngs


def _actions(rng, shape):
    action = rng.uniform(-0.12, 0.12, shape + (2,)).astype(np.float32)
    # Exact bin edges of vocab 256 and the clip bounds themselves.
    edges = (np.arange(0, 256, 17, dtype=np.float32) / 255.0 * 0.2 - 0.1).astype(np.float32)
    flat = action.reshape(-1)
    flat[: edges.size] = edges
    flat[edges.size: edges.size + 4] = [-0.1, 0.1, -0.2, 0.2]
    return {"terminate_episode": rng.integers(0, 2, shape).astype(np.int32), "action": action}


@pytest.mark.parametrize("vocab", [256, 32])
def test_tokenize_and_continuous_targets_are_exact(vocab):
    rng = np.random.default_rng(31)
    actions = _actions(rng, (6, 9))
    ref = np.asarray(jax_tokenizer.tokenize(jax_action_space(), actions, vocab))
    out = action_tokenizer.tokenize(language_table_action_space(),
                                    {k: torch.from_numpy(v) for k, v in actions.items()}, vocab)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    ref = np.asarray(jax_tokenizer.continuous_targets(jax_action_space(), actions))
    out = action_tokenizer.continuous_targets(
        language_table_action_space(), {k: torch.from_numpy(v) for k, v in actions.items()})
    np.testing.assert_array_equal(out.numpy(), ref)


def test_random_shift_crop_is_a_window_of_the_padded_input():
    rng = np.random.default_rng(32)
    images = torch.from_numpy(rng.uniform(0.1, 1, (2, 3, 30, 57, 3)).astype(np.float32))
    ratio = 0.07
    pad_h, pad_w = int(30 * ratio), int(57 * ratio)
    padded = torch.nn.functional.pad(images, (0, 0, pad_w, pad_w, pad_h, pad_h))
    offsets = set()
    for seed in range(60):
        out = random_shift_crop(images, torch.Generator().manual_seed(seed), ratio)
        assert out.shape == images.shape
        match = [(dh, dw) for dh in range(2 * pad_h + 1) for dw in range(2 * pad_w + 1)
                 if torch.equal(out, padded[..., dh:dh + 30, dw:dw + 57, :])]
        assert len(match) == 1, seed
        offsets.add(match[0])
        again = random_shift_crop(images, torch.Generator().manual_seed(seed), ratio)
        assert torch.equal(out, again)
    rows = {dh for dh, _ in offsets}
    cols = {dw for _, dw in offsets}
    assert rows == set(range(2 * pad_h + 1)) and cols <= set(range(2 * pad_w + 1))
    assert len(cols) > pad_w  # offsets spread over the range


def test_convert_and_crop_needs_a_generator_only_in_train_mode():
    images = torch.zeros((1, 1, 20, 30, 3), dtype=torch.uint8) + 255
    out = convert_dtype_and_crop_images(images, train=False)
    assert out.dtype == torch.float32 and torch.all(out == 1.0)
    with pytest.raises(ValueError, match="generator"):
        convert_dtype_and_crop_images(images, train=True)
    assert torch.equal(convert_dtype_and_crop_images(images, ratio=0.0, train=True), out)


def test_dropout_law():
    rate, n = 0.1, 200_000
    x = torch.full((n,), 2.0)
    out = dropout(x, rate, True, {"dropout": torch.Generator().manual_seed(0)})
    kept = out != 0
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(kept.float().mean().item() - (1 - rate)) < 4.5 * sigma
    assert torch.allclose(out[kept], torch.full_like(out[kept], 2.0 / (1 - rate)))
    again = dropout(x, rate, True, {"dropout": torch.Generator().manual_seed(0)})
    assert torch.equal(out, again)
    assert dropout(x, rate, False, None) is x
    assert dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="dropout"):
        dropout(x, rate, True, {})


def test_lr_schedule_matches_optax_across_milestones():
    milestones, spe, base, gamma = (2, 3, 5), 7, 5e-4, 0.1
    ref = jax_multistep_lr(base, milestones, gamma, spe)
    ours = multistep_lr(base, milestones, gamma, spe)
    for count in range(0, 6 * spe + 2):
        expect = np.float32(ref(jnp.asarray(count, jnp.int32)))
        got = ours(torch.tensor(count)).item()
        assert np.float32(got) == expect, count
    assert ours(torch.tensor(2 * spe - 1)).item() == pytest.approx(base)
    assert ours(torch.tensor(2 * spe)).item() == pytest.approx(base * gamma)


@pytest.mark.parametrize("name,jax_module", [("tiny", jax_tiny), ("language_table", jax_language_table)])
def test_training_config_matches_jax(name, jax_module):
    jcfg = jax_module.get_config()
    cfg = get_config(name)
    for field in ("per_host_batch_size", "num_steps", "steps_per_epoch", "learning_rate",
                  "lr_gamma", "grad_clip_norm", "accum_steps", "seed", "checkpoint_every_steps",
                  "max_to_keep", "keep_period", "log_every_steps", "eval_every_steps",
                  "eval_batches"):
        assert getattr(cfg, field) == jcfg[field], field
    assert tuple(cfg.lr_milestones) == tuple(jcfg.lr_milestones)
    assert cfg.resilience.guard == jcfg.resilience.guard
    assert cfg.parallel.mixed_precision == jcfg.parallel.mixed_precision
    assert jcfg.data.data_dir == ""  # JAX trains on synthetic batches too


def test_overrides():
    cfg = get_config("tiny")
    for assignment in ("model.dropout_rate=0", "num_steps=6", "lr_milestones=50,75",
                       "max_to_keep=2", "resilience.guard=false", "model.attention_impl=fused",
                       "regularization.crop_ratio=0", "parallel.mixed_precision=True"):
        apply_override(cfg, assignment)
    assert cfg.model.dropout_rate == 0.0 and isinstance(cfg.model.dropout_rate, float)
    assert (cfg.num_steps, cfg.lr_milestones, cfg.max_to_keep) == (6, (50, 75), 2)
    assert not cfg.resilience.guard and cfg.parallel.mixed_precision
    assert cfg.model.attention_impl == "fused" and cfg.regularization.crop_ratio == 0.0
    apply_override(cfg, "max_to_keep=None")
    assert cfg.max_to_keep is None
    for bad in ("model.nope=1", "num_steps=x", "model=1", "num_steps", "resilience.guard=2"):
        with pytest.raises(ValueError):
            apply_override(cfg, bad)


def test_synthetic_batches_and_rngs_are_functions_of_seed_and_step():
    cfg = get_config("tiny")
    a, b = synthetic_batch(cfg, 3, 5, "cpu"), synthetic_batch(cfg, 3, 5, "cpu")
    c = synthetic_batch(cfg, 3, 6, "cpu")
    for tree_a, tree_b, tree_c in zip(a, b, c):
        for key in tree_a:
            assert torch.equal(tree_a[key], tree_b[key])
            assert not torch.equal(tree_a[key], tree_c[key])
    obs, actions = a
    assert obs["image"].shape == (8, 3, 32, 56, 3) and 0 <= obs["image"].min() < obs["image"].max() < 1
    assert actions["action"].abs().max() <= 0.1 and set(actions["terminate_episode"].unique().tolist()) <= {0, 1}
    for augment, streams in ((False, {"crop", "dropout", "stochastic_depth"}),
                             (True, {"crop", "dropout", "stochastic_depth", "augment"})):
        draws, again, other = ({name: torch.rand(4, generator=g)
                                for name, g in step_rngs(1, step, "cpu", augment=augment).items()}
                               for step in (2, 2, 3))
        assert set(draws) == streams
        for name in draws:
            assert torch.equal(draws[name], again[name]) and not torch.equal(draws[name],
                                                                             other[name])
        assert len({tuple(v.tolist()) for v in draws.values()}) == len(streams)


def test_crop_on_host_draws_the_crop_on_the_host_on_every_device(monkeypatch):
    """The card's generator (Philox) and the host's (Mersenne Twister)
    draw different offsets from one seed. With `crop_on_host` the crop's
    generator is the host's whatever the step's device (so a seed crops
    alike on the card and on the CPU); the masks' stay on the step's
    device, as every stream does without it (recorded here: this host has
    no card, so a host generator stands in for each)."""
    real = torch.Generator

    def made_on(**kw):
        made = []

        def recording(device="cpu"):
            made.append(torch.device(device))
            return real()

        monkeypatch.setattr(torch, "Generator", recording)
        rngs = step_rngs(1, 2, "cuda", augment=True, **kw)
        monkeypatch.undo()
        return dict(zip(rngs, made))

    cuda = torch.device("cuda")
    assert made_on() == dict.fromkeys(RNG_STREAMS, cuda)
    assert made_on(crop_on_host=True) == {**dict.fromkeys(RNG_STREAMS, cuda),
                                          "crop": torch.device("cpu")}
    images = torch.rand(2, 3, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    want = random_shift_crop(images, step_rngs(1, 2, "cpu")["crop"], 0.07)
    # Images on another device than the generator's (the card's case):
    # the offsets are drawn on the host, the window cut on the images'.
    out = random_shift_crop(images.to("meta"), step_rngs(1, 2, "cpu")["crop"], 0.07)
    assert out.device == torch.device("meta") and out.shape == want.shape


def test_global_norm_is_accurate_on_a_long_float32_vector():
    """The gradient norm of a flagship-sized gradient (millions of float32
    elements, a few large): within 1e-6 of the float64 norm, where the CPU's
    float32 `linalg.vector_norm` is off by ~1e-2."""
    x = torch.randn(8_000_000, generator=torch.Generator().manual_seed(0)) * 1e-3
    x[:1000] *= 1000
    ref = x.double().norm().item()
    assert global_norm(x).item() == pytest.approx(ref, rel=1e-6)
