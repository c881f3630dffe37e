"""The port's fused attention against the JAX package's Pallas kernel.

On the CPU the port's `fused_attention` runs its plain version
(`fused_attention_reference`); the JAX side runs the Pallas kernel in
interpret mode, as tests/test_flash_attention.py does. Same numpy-seeded
inputs, the four cases of that file (atol 2e-5 in f32, 2e-2 in bf16, whose
last place is 2**-7 near 1), plus a ragged sequence and a fully masked row.
The CUDA kernel itself is held against the same plain version on the card
by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.models.rt1 import rt1_attention_mask as jax_rt1_mask
from rt1_tpu.parallel.flash_attention import fused_attention as jax_fused_attention
from rt1_tpu.parallel.ring_attention import dense_attention_reference
from rt1_tpu_torch.models.rt1 import rt1_attention_mask
from rt1_tpu_torch.parallel import flash_attention as port

torch.set_num_threads(2)

B, S, H, D = 2, 66, 4, 16  # RT-1's window: 6 x (8 + 3) = 66 tokens


def _qkv(seed, s=S, d=D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, s, H, d), dtype=np.float32) for _ in range(3))


def _masks(kind, s):
    if kind == "none":
        return None
    if kind == "rt1":
        return jax_rt1_mask(time_sequence_length=6, tokens_per_image=8, tokens_per_action=3)
    return np.tril(np.ones((s, s), np.int32))


@pytest.mark.parametrize(
    "seed,kind,dtype,s,atol",
    [
        (0, "none", "float32", S, 2e-5),
        (1, "rt1", "float32", S, 2e-5),
        (2, "causal", "float32", S, 2e-5),
        (3, "none", "bfloat16", S, 2e-2),
        (4, "causal", "float32", 37, 2e-5),
    ],
)
def test_plain_matches_pallas_interpret(seed, kind, dtype, s, atol):
    q, k, v = _qkv(seed, s=s)
    mask = _masks(kind, s)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jax_fused_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
        mask=None if mask is None else jnp.asarray(mask),
        interpret=True,
    )
    out = port.fused_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        mask=None if mask is None else torch.from_numpy(np.asarray(mask)),
    )
    assert out.dtype == tdt and tuple(out.shape) == (B, s, H, D)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=atol, rtol=0
    )


def test_port_rt1_mask_equals_jax():
    np.testing.assert_array_equal(
        rt1_attention_mask(6, 8, 3), jax_rt1_mask(6, 8, 3)
    )


def test_fully_masked_row_is_mean_of_real_values():
    """A row whose logits are all -1e9 averages the s real value rows, as
    the dense reference does (not the Pallas wrapper's padded mean)."""
    q, k, v = _qkv(7, s=37)
    mask = np.tril(np.ones((37, 37), np.int32))
    mask[5] = 0
    out = port.fused_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               mask=torch.from_numpy(mask))
    ref = dense_attention_reference(*(jnp.asarray(x) for x in (q, k, v)),
                                    mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.numpy()[:, 5], v.mean(axis=1), atol=2e-5, rtol=0)


class _FakeCudaTensor:
    """Stands in for a CUDA tensor on a host without CUDA: the wrapper must
    route it to the kernel launch, never to the plain version."""

    device = torch.device("cuda")
    dtype = torch.float32
    shape = torch.Size((B, S, H, D))

    def dim(self):
        return 4

    def stride(self, dim=None):
        strides = (S * H * D, H * D, D, 1)
        return strides if dim is None else strides[dim]


def test_cuda_tensor_never_reaches_plain_path(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("plain path called for a CUDA tensor")

    launched = []
    monkeypatch.setattr(port, "fused_attention_reference", forbidden)
    monkeypatch.setattr(port, "_launch", lambda *a: launched.append(a) or "kernel")
    x = _FakeCudaTensor()
    assert port.fused_attention(x, x, x) == "kernel"
    assert len(launched) == 1


def test_cuda_launch_without_toolchain_raises(monkeypatch):
    """With no nvcc the launch raises; it does not fall back to the CPU."""
    monkeypatch.setattr(port, "fused_attention_reference",
                        lambda *a, **k: pytest.fail("fell back to the plain path"))
    monkeypatch.setattr(port, "_find_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))
    monkeypatch.setattr(port, "library_path", lambda: "/nonexistent/libfused_attention.so")
    port._library.cache_clear()
    x = _FakeCudaTensor()
    before = port.fused_attention.launches
    with pytest.raises(RuntimeError):
        port.fused_attention(x, x, x)
    assert port.fused_attention.launches == before
    port._library.cache_clear()


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros((B, S, H, D))
    with pytest.raises(ValueError):
        port.fused_attention(q, q[:, :10], q)
    with pytest.raises(ValueError):
        port.fused_attention(q, q, q, mask=torch.ones((S, S + 1)))
