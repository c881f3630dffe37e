"""`rt1_tpu_torch/ops/image.py`'s eval-side resize and central crop, and the
port's EfficientNet classifier head, against the JAX package's.

* `resize_bilinear` and `central_crop_and_resize` against
  `rt1_tpu/ops/image.py`'s (`jax.image.resize(method="bilinear")`:
  half-pixel centres, the triangle kernel widened when downscaling) on f32
  NHWC inputs in [0, 1] with leading dims, down and up, crop factors 0.95
  and 0.8, at small sizes and at the eval's own 180x320 -> 256x456 (where
  XLA's fused multiply-add in the sample coordinate, one rounding, is
  what a two-rounding evaluation misses): atol 1e-5.
* The classifier head (`EfficientNet(include_top=True)`: mean over H and
  W, dropout in train mode only, `classifier`) at width and depth 0.35 on
  one set of drawn variables: eval-mode logits within 1e-4 of JAX's;
  train-mode dropout draws from `rngs["dropout"]` and raises without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from rt1_tpu.ops import image as jax_image
from rt1_tpu_torch.convert import flax_paths
from rt1_tpu_torch.models.efficientnet import EfficientNet
from rt1_tpu_torch.ops import image
from test_torch_modules import apply, init, randomized, to_port

torch.set_num_threads(2)

RESIZES = [
    ((2, 3, 45, 80, 3), (32, 56)),   # down, two leading dims
    ((2, 3, 32, 56, 3), (45, 80)),   # up
    ((2, 37, 53, 3), (16, 20)),      # down by more than 2
    ((4, 13, 17, 3), (40, 64)),      # up by more than 3
    ((5, 9, 3), (5, 30)),            # one axis unchanged, no batch dim
    ((2, 64, 64, 1), (1, 1)),        # to one pixel
    ((2, 180, 320, 3), (256, 456)),  # a collected frame to the flagship's input
    ((1, 256, 456, 3), (300, 300)),  # the flagship's input to B3's ImageNet size
]


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("shape,size", RESIZES)
def test_resize_bilinear_matches_jax(shape, size):
    x = _images(shape, 0)
    want = np.asarray(jax_image.resize_bilinear(jnp.asarray(x), *size))
    got = image.resize_bilinear(torch.from_numpy(x), *size)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("crop_factor", [0.95, 0.8])
@pytest.mark.parametrize("shape,size", [((2, 3, 45, 80, 3), (32, 56)),
                                        ((3, 30, 41, 3), (48, 64)),
                                        ((2, 180, 320, 3), (256, 456))])
def test_central_crop_and_resize_matches_jax(shape, size, crop_factor):
    x = _images(shape, 1)
    want = np.asarray(jax_image.central_crop_and_resize(jnp.asarray(x), crop_factor, *size))
    got = image.central_crop_and_resize(torch.from_numpy(x), crop_factor, *size)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_resize_takes_uint8_as_float():
    x = (np.random.default_rng(3).uniform(0, 255, (2, 9, 11, 3))).astype(np.uint8)
    want = np.asarray(jax_image.resize_bilinear(jnp.asarray(x), 6, 7))
    got = image.resize_bilinear(torch.from_numpy(x), 6, 7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def _classifier_pair():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = JaxEfficientNet(width_coefficient=0.35, depth_coefficient=0.35, include_top=True,
                         classes=12)
    variables = randomized(init(jm, x, train=False), 5)
    pm = to_port(EfficientNet(0.35, 0.35, include_top=True, classes=12), variables)
    return jm, variables, pm, x


def test_classifier_head_matches_jax():
    jm, variables, pm, x = _classifier_pair()
    want = apply(jm, variables, x, train=False)
    assert tuple(pm.classifier.weight.shape) == (12, pm.top_ch)
    paths = flax_paths(pm)
    assert (paths["classifier.weight"], paths["classifier.bias"]) == \
        ("params/classifier/kernel", "params/classifier/bias")
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 12) and float(got.abs().max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_classifier_dropout_acts_in_train_mode_only():
    _, _, pm, x = _classifier_pair()
    pm.drop_connect_rate = 0.0
    for i in range(pm.num_blocks):
        getattr(pm, f"block_{i}").drop_rate = 0.0
    x = torch.from_numpy(x)
    with pytest.raises(ValueError, match="dropout"):
        pm(x, train=True)
    with torch.no_grad():
        plain = pm(x, train=True, rngs={"dropout": torch.Generator().manual_seed(0)})
        pm.dropout_rate = 0.0
        undropped = pm(x, train=True, rngs={})
        one = pm(x, train=False)
        pm.dropout_rate = 0.5
        two = pm(x, train=False)
    assert not torch.equal(plain, undropped)
    assert torch.equal(one, two)  # eval mode never drops
