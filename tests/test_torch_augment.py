"""Photometric augmentation (`rt1_tpu_torch/ops/augment.py`) against
`rt1_tpu/ops/augment.py`, on the CPU in float32.

* Every function on seeded numpy images within 1e-5: the RGB <-> HSV round
  trip (greys, primaries, a hue at the wrap), brightness, contrast,
  saturation and hue with deltas that wrap the hue past 0 and 1.
* `photometric_distortions` on the same factors: the levels JAX draws from
  its key (split in four, as its function splits it) applied by the port
  give JAX's images.
* One draw per call: one level a distortion for the whole batch, four
  draws from the generator.
* The train forward: with the flag off it is the forward without the
  `augment` stream, bit for bit; on with every range at identity it equals
  off; on, it changes the loss and is reproducible from the same seeds.
  The train step's `augment` stream leaves the other streams' seeds as
  they were, and the step seeds it only with the flag on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.ops import augment as jax_augment
from rt1_tpu_torch.configs import apply_override, get_config
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.ops import augment
from rt1_tpu_torch.train.train import synthetic_batch
from rt1_tpu_torch.trainer.train import RNG_STREAMS, step_rngs, train_step_fns_from_config

ATOL = 1e-5


def _images(seed=0, shape=(2, 3, 8, 10, 3)):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, shape).astype(np.float32)
    flat = images.reshape(-1, 3)
    flat[:5] = [[0.5, 0.5, 0.5], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1.0, 0.0, 0.02]]
    flat[5:8] = [[0, 0, 0], [1, 1, 1], [0.3, 0.3, 0.9]]
    return images


def _close(ours, theirs):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=ATOL)


def test_hsv_round_trip_matches_jax():
    images = _images(1)
    hsv = augment.rgb_to_hsv(torch.from_numpy(images))
    _close(hsv, jax_augment.rgb_to_hsv(jnp.asarray(images)))
    rng = np.random.default_rng(2)
    hsv_in = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    hsv_in[:4, 0] = [0.0, 0.999999, 1.0 / 6.0, 5.0 / 6.0]  # sector edges and the wrap
    _close(augment.hsv_to_rgb(torch.from_numpy(hsv_in)), jax_augment.hsv_to_rgb(jnp.asarray(hsv_in)))
    _close(augment.hsv_to_rgb(hsv), images)


@pytest.mark.parametrize("fn,values", [
    ("adjust_brightness", (-0.1, 0.0, 0.07)),
    ("adjust_contrast", (0.8, 1.0, 1.2)),
    ("adjust_saturation", (0.8, 1.0, 1.2)),
    ("adjust_hue", (-0.03, 0.03, -0.6, 0.75)),  # the last two wrap every hue
])
def test_adjust_functions_match_jax(fn, values):
    images = _images(3)
    for value in values:
        ours = getattr(augment, fn)(torch.from_numpy(images), torch.tensor(value))
        theirs = getattr(jax_augment, fn)(jnp.asarray(images), jnp.float32(value))
        _close(ours, theirs)


def _jax_factors(key, config):
    """The levels JAX's `photometric_distortions` draws from `key`."""
    r0, r1, r2, r3 = jax.random.split(key, 4)
    return {
        "brightness": jax.random.uniform(r0, minval=-config.brightness_max_delta,
                                         maxval=config.brightness_max_delta),
        "saturation": jax.random.uniform(r1, minval=config.saturation_lower,
                                         maxval=config.saturation_upper),
        "hue": jax.random.uniform(r2, minval=-config.hue_max_delta,
                                  maxval=config.hue_max_delta),
        "contrast": jax.random.uniform(r3, minval=config.contrast_lower,
                                       maxval=config.contrast_upper),
    }


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_photometric_distortions_on_the_same_factors(seed):
    images = _images(seed)
    key = jax.random.PRNGKey(seed)
    theirs = jax_augment.photometric_distortions(jnp.asarray(images), key)
    factors = {k: torch.tensor(float(v)) for k, v in
               _jax_factors(key, jax_augment.PhotometricConfig()).items()}
    _close(augment.apply_photometric(torch.from_numpy(images), factors), theirs)
    assert augment.PhotometricConfig() == augment.PhotometricConfig(
        **vars(jax_augment.PhotometricConfig()))


def test_one_draw_per_call():
    config = augment.PhotometricConfig()
    g = torch.Generator().manual_seed(5)
    factors = augment.draw_photometric_factors(g, config)
    assert list(factors) == ["brightness", "saturation", "hue", "contrast"]
    assert all(f.shape == () and f.dtype == torch.float32 for f in factors.values())
    ref = torch.Generator().manual_seed(5)
    draws = [torch.rand((), generator=ref) for _ in range(4)]
    assert torch.equal(torch.rand((), generator=g), torch.rand((), generator=ref))
    assert -0.1 <= factors["brightness"] <= 0.1 and 0.8 <= factors["contrast"] <= 1.2
    assert torch.allclose(factors["hue"], -0.03 + 0.06 * draws[2])
    # One brightness level for the whole batch: every pixel moves by it.
    only = augment.PhotometricConfig(brightness_max_delta=0.1, contrast_lower=1.0,
                                     contrast_upper=1.0, hue_max_delta=0.0,
                                     saturation_lower=1.0, saturation_upper=1.0)
    flat = torch.full((4, 3, 5, 6, 3), 0.5)
    out = augment.photometric_distortions(flat, torch.Generator().manual_seed(1), only)
    assert torch.unique(out).numel() == 1 and not torch.equal(out, flat)
    # Identity levels leave the images where they were.
    identity = {"brightness": torch.tensor(0.0), "saturation": torch.tensor(1.0),
                "hue": torch.tensor(0.0), "contrast": torch.tensor(1.0)}
    images = torch.from_numpy(_images(4))
    torch.testing.assert_close(augment.apply_photometric(images, identity), images,
                               rtol=0, atol=1e-6)


def _forward_loss(policy, batch, rngs):
    torch.manual_seed(0)
    with torch.no_grad():
        return policy(*batch, train=True, rngs=rngs)["loss"]


def test_train_forward_with_the_flag_off_on_and_at_identity():
    config = get_config("tiny")
    torch.manual_seed(3)
    policy = build_policy(config)
    batch = synthetic_batch(config, seed=1, index=0, device="cpu")
    rngs = step_rngs(42, 5, "cpu", augment=True)
    assert RNG_STREAMS[-1] == "augment" and set(rngs) == set(RNG_STREAMS)
    off = _forward_loss(policy, batch, rngs)
    # The pre-augment streams, seeded as before: the same loss bit for bit.
    reseeded = step_rngs(42, 5, "cpu")
    assert set(reseeded) == set(RNG_STREAMS) - {"augment"}
    assert torch.equal(off, _forward_loss(policy, batch, reseeded))

    apply_override(config, "model.photometric_augmentation=True")
    aug = build_policy(config)
    aug.load_state_dict(policy.state_dict())
    on = _forward_loss(aug, batch, step_rngs(42, 5, "cpu", augment=True))
    assert not torch.equal(on, off)
    assert torch.equal(on, _forward_loss(aug, batch, step_rngs(42, 5, "cpu", augment=True)))
    # Without an augment stream the crop stream draws the levels, as in JAX.
    assert torch.isfinite(_forward_loss(aug, batch, reseeded))
    aug.photometric_config = augment.PhotometricConfig(
        brightness_max_delta=0.0, contrast_lower=1.0, contrast_upper=1.0, hue_max_delta=0.0,
        saturation_lower=1.0, saturation_upper=1.0)
    assert torch.equal(_forward_loss(aug, batch, step_rngs(42, 5, "cpu", augment=True)), off)
    # Neither an augment nor a crop stream (no crop): the forward refuses.
    aug.crop_ratio = 0.0
    bare = {k: v for k, v in reseeded.items() if k != "crop"}
    with pytest.raises(ValueError, match="augment"):
        _forward_loss(aug, batch, bare)


def test_augment_stream_leaves_the_other_seeds():
    for seed, step, micro in ((42, 0, 0), (7, 13, 2)):
        rngs = step_rngs(seed, step, "cpu", micro=micro, augment=True)
        for index, name in enumerate(("crop", "dropout", "stochastic_depth")):
            words = np.random.SeedSequence([seed, step, index, micro]).generate_state(2, np.uint32)
            assert rngs[name].initial_seed() == (int(words[0]) << 31) ^ int(words[1])
        others = {rngs[name].initial_seed() for name in ("crop", "dropout", "stochastic_depth")}
        assert rngs["augment"].initial_seed() not in others
    assert "augment" not in step_rngs(42, 0, "cpu")
    config = get_config("tiny")
    assert not train_step_fns_from_config(config).photometric_augmentation
    apply_override(config, "model.photometric_augmentation=True")
    assert train_step_fns_from_config(config).photometric_augmentation
