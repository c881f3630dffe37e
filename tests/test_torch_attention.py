"""The port's fused attention against the JAX package's Pallas kernel.

On the CPU the port's `fused_attention` runs its plain version
(`fused_attention_reference`); the JAX side runs the Pallas kernel in
interpret mode, as tests/test_flash_attention.py does. Same numpy-seeded
inputs, the four cases of that file (atol 2e-5 in f32, 2e-2 in bf16, whose
last place is 2**-7 near 1), plus a ragged sequence and a fully masked row.
The CUDA kernel itself is held against the same plain version on the card
by chip_smoke.py. Concurrent builds of the kernel library (a fake nvcc)
leave the library and ptxas's report whole.
"""

import os
import sys

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


# The bf16 tensor-core kernel's precision scheme, emulated in plain PyTorch
# and held to the JAX function in fp32, before the final cast to bf16. On
# the card its bf16 output is held to within one bf16 ulp of the plain
# version (chip_smoke.py); a bf16 output's ulp (2**-8 relative) is coarser
# than a single bf16 P's error (2**-9), so only this fp32 comparison can
# tell the split P from a single bf16 P.

SCHEME_TOL = 1e-4
SERVE_B, SERVE_H, SERVE_D = 2, 8, 128  # the serve shape at bucket 2


def _bf16_inputs(seed, s, b=SERVE_B, h=SERVE_H, d=SERVE_D):
    """float32 q/k/v whose values are bf16-representable."""
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32))
        .to(torch.bfloat16).float().numpy()
        for _ in range(3)
    )


def _tensor_core_scheme(q, k, v, mask, split_p=True):
    """fp32 emulation of csrc/fused_attention_tc.cu: bf16 x bf16 products
    summed in fp32, `scale` applied to the fp32 logits, -1e9 where the mask
    is 0, an fp32 softmax in base 2, and P split into hi = bf16(p) and
    lo = bf16(p - hi) for the PV product (a single bf16 P when `split_p` is
    False), normalised by the fp32 row sum at the end."""
    qf, kf, vf = (torch.from_numpy(x) for x in (q, k, v))
    log2e = 1.4426950408889634
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * np.float32(log2e / q.shape[-1] ** 0.5)
    if mask is not None:
        keep = torch.from_numpy(np.asarray(mask) != 0)
        logits = torch.where(keep, logits, torch.tensor(-1e9 * log2e, dtype=torch.float32))
    p = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    parts = [hi, (p - hi).to(torch.bfloat16).float()] if split_p else [hi]
    out = sum(torch.einsum("bhqk,bkhd->bqhd", part, vf) for part in parts)
    return (out / p.sum(dim=-1).permute(0, 2, 1)[..., None]).numpy()


def _masked_rows_mask():
    mask = np.asarray(jax_rt1_mask(6, 8, 3), np.int32).copy()
    mask[[0, 30, 65]] = 0
    return mask


def _f32_inputs(seed, s, b=SERVE_B, h=SERVE_H, d=SERVE_D):
    """float32 q/k/v, standard normal: most values are not tf32-representable."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d), dtype=np.float32) for _ in range(3))


def _scheme_case(name, inputs=_bf16_inputs):
    """(q, k, v, mask, fp32 reference). The fully masked rows are held to
    dense_attention_reference: the Pallas wrapper's padding averages them
    over the padded keys too (test_fully_masked_row_is_mean_of_real_values)."""
    if name == "serve_b2_rt1":
        q, k, v = inputs(10, S)
        mask = np.asarray(jax_rt1_mask(6, 8, 3))
    elif name == "ragged_s37_causal":
        q, k, v = inputs(11, 37)
        mask = np.tril(np.ones((37, 37), np.int32))
    else:
        q, k, v = inputs(12, S)
        mask = _masked_rows_mask()
        ref = dense_attention_reference(*(jnp.asarray(x) for x in (q, k, v)),
                                        mask=jnp.asarray(mask))
        return q, k, v, mask, np.asarray(ref, np.float32)
    ref = jax_fused_attention(*(jnp.asarray(x) for x in (q, k, v)), mask=jnp.asarray(mask),
                              interpret=True)
    return q, k, v, mask, np.asarray(ref, np.float32)


SCHEME_CASES = ["serve_b2_rt1", "ragged_s37_causal", "serve_b2_masked_rows"]


@pytest.mark.parametrize("name", SCHEME_CASES)
def test_tensor_core_scheme_matches_jax_in_fp32(name):
    q, k, v, mask, ref = _scheme_case(name)
    out = _tensor_core_scheme(q, k, v, mask)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=SCHEME_TOL, rtol=0)


@pytest.mark.parametrize("name", SCHEME_CASES)
def test_single_bf16_p_is_another_function(name):
    """A single bf16 P (what SDPA and the dense path use) misses the same
    bound on the same inputs, so the fp32 comparison above can tell."""
    q, k, v, mask, ref = _scheme_case(name)
    err = np.abs(_tensor_core_scheme(q, k, v, mask, split_p=False) - ref).max()
    assert err > SCHEME_TOL


def _strides(s, h, d):
    return (s * h * d, h * d, d) * 3


@pytest.mark.parametrize(
    "dtype,d,strides,ptrs,expected",
    [
        (torch.bfloat16, 128, _strides(66, 8, 128), (0, 1 << 20, 2 << 20), "tensor_core"),
        (torch.bfloat16, 64, _strides(66, 8, 64), (0, 1 << 20, 2 << 20, 3 << 20), "tensor_core"),
        # d = 48 is a multiple of 16: padded to 64 in shared memory.
        (torch.bfloat16, 48, _strides(66, 8, 48), (0, 1 << 20, 2 << 20), "tensor_core"),
        (torch.float32, 128, _strides(66, 8, 128), (0, 1 << 20, 2 << 20), "tf32x3"),
        (torch.bfloat16, 40, _strides(66, 8, 40), (0, 1 << 20, 2 << 20), "simple"),
        (torch.bfloat16, 272, _strides(66, 8, 272), (0, 1 << 20, 2 << 20), "simple"),
        (torch.bfloat16, 128, _strides(66, 8, 128), (0, (1 << 20) + 8, 2 << 20), "simple"),
        # a mask whose base is not 16-byte aligned
        (torch.bfloat16, 128, _strides(66, 8, 128), (0, 1 << 20, 2 << 20, (3 << 20) + 4), "simple"),
        # a sequence stride of 1028 bf16 elements: rows 8 bytes off 16-byte alignment
        (torch.bfloat16, 128, (66 * 1028, 1028, 128) * 3, (0, 1 << 20, 2 << 20), "simple"),
        # float32: d a multiple of 8 up to 256, rows 16-byte aligned -> tf32x3
        (torch.float32, 128, _strides(66, 8, 128), (0, 1 << 20, 2 << 20, 3 << 20), "tf32x3"),
        (torch.float32, 8, _strides(15, 2, 8), (0, 1 << 20, 2 << 20, 3 << 20), "tf32x3"),  # tiny
        (torch.float32, 256, _strides(66, 8, 256), (0, 1 << 20, 2 << 20), "tf32x3"),
        # q/k/v as views of one packed (b, s, 3, h, d) projection
        (torch.float32, 128, (66 * 3 * 1024, 3 * 1024, 128) * 3,
         (0, 1024 * 4, 2048 * 4), "tf32x3"),
        (torch.float32, 12, _strides(66, 8, 12), (0, 1 << 20, 2 << 20), "simple"),
        (torch.float32, 264, _strides(66, 8, 264), (0, 1 << 20, 2 << 20), "simple"),
        # a float32 view one element into its storage: rows 4 bytes off
        (torch.float32, 128, _strides(66, 8, 128), (4, (1 << 20) + 4, (2 << 20) + 4), "simple"),
        # a sequence stride of 1026 floats: rows 8 bytes off 16-byte alignment
        (torch.float32, 128, (66 * 1026, 1026, 128) * 3, (0, 1 << 20, 2 << 20), "simple"),
        (torch.float32, 128, _strides(66, 8, 128), (0, 1 << 20, 2 << 20, (3 << 20) + 8), "simple"),
    ],
)
def test_variant_rule(dtype, d, strides, ptrs, expected):
    assert port._variant(dtype, d, strides, ptrs) == expected


def test_variant_of_reads_the_tensors():
    """`variant_of` applies the rule to real tensors' pointers and strides."""
    x = torch.zeros((2, S, 8, 128))
    mask = torch.ones((S, S), dtype=torch.uint8)
    assert port.variant_of(x, x, x, mask) == "tf32x3"
    assert port.variant_of(*(x.to(torch.bfloat16),) * 3) == "tensor_core"
    off = torch.zeros(2 * S * 8 * 128 + 1)[1:].view(2, S, 8, 128)
    assert port.variant_of(off, off, off) == "simple"
    packed = torch.zeros((2, S, 3, 8, 128))
    assert port.variant_of(packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]) == "tf32x3"


class _FakeLaunchTensor:
    """A CUDA-resident tensor as `_launch` sees it, on a host without CUDA."""

    device = torch.device("cuda", 0)

    def __init__(self, dtype, shape, ptr, strides=None):
        self.dtype, self.shape, self._ptr = dtype, torch.Size(shape), ptr
        b, s, h, d = shape
        self._strides = strides or (s * h * d, h * d, d, 1)

    def dim(self):
        return 4

    def stride(self, dim=None):
        return self._strides if dim is None else self._strides[dim]

    def data_ptr(self):
        return self._ptr

    def is_contiguous(self):
        return True


class _FakeLibrary:
    def __init__(self):
        self.calls = []
        self.rt1_fused_attention_tc_fwd = lambda *a: self.calls.append(("tensor_core", a)) or 0
        self.rt1_fused_attention_tf32x3_fwd = lambda *a: self.calls.append(("tf32x3", a)) or 0
        self.rt1_fused_attention_fwd = lambda *a: self.calls.append(("simple", a)) or 0


@pytest.mark.parametrize(
    "dtype,d,expected",
    [(torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
     (torch.float32, 128, "tf32x3"), (torch.bfloat16, 40, "simple"),
     (torch.float32, 8, "tf32x3"), (torch.float32, 12, "simple")],
)
def test_launch_routes_by_variant_rule(monkeypatch, dtype, d, expected):
    """`_launch` calls the C entry point `_variant` names, with the wrapper's
    query slices per block for the tensor-core kernels, and counts the launch under
    that variant and in the total."""
    lib = _routing_library(monkeypatch)
    q, k, v = (_FakeLaunchTensor(dtype, (2, S, 8, d), (i + 1) << 20) for i in range(3))
    mask = _FakeLaunchTensor(torch.uint8, (1, 1, S, S), 4 << 20)
    mask.shape = torch.Size((S, S))
    out = port.fused_attention(q, k, v, mask=mask)
    assert tuple(out.shape) == (2, S, 8, d) and out.dtype == dtype
    assert [name for name, _ in lib.calls] == [expected]
    args = lib.calls[0][1]
    assert args[:5] == (1 << 20, 2 << 20, 3 << 20, 4 << 20, out.data_ptr())
    if expected == "tensor_core":
        assert args[-2] == port.TC_SLICES_PER_BLOCK
    if expected == "tf32x3":
        assert args[-2] == port.TF32X3_SLICES_PER_BLOCK
    assert port.fused_attention.launches == 1
    assert port.fused_attention.launches_by_variant == {
        name: int(name == expected) for name in port.VARIANTS}


def _routing_library(monkeypatch):
    """A fake kernel library behind `_launch`, with zeroed launch counts and
    `torch.empty` allocating on the CPU."""
    lib = _FakeLibrary()
    monkeypatch.setattr(port, "_library", lambda: lib)
    monkeypatch.setattr(port, "_current_stream", lambda device: 0)
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, dtype, device: real_empty(shape, dtype=dtype))
    monkeypatch.setattr(port.fused_attention, "launches", 0)
    monkeypatch.setattr(port.fused_attention, "launches_by_variant",
                        dict.fromkeys(port.VARIANTS, 0))
    return lib


def test_forcing_the_tensor_core_kernel_on_float32_raises(monkeypatch):
    monkeypatch.setattr(port, "_library", _FakeLibrary)
    x = _FakeLaunchTensor(torch.float32, (2, S, 8, 128), 1 << 20)
    with pytest.raises(ValueError):
        port._launch(x, x, x, None, 0.1, variant="tensor_core")


@pytest.mark.parametrize(
    "dtype,d,ptr",
    [(torch.bfloat16, 128, 1 << 20),   # bf16 is the tensor-core kernel's
     (torch.float32, 12, 1 << 20),     # d not a multiple of 8
     (torch.float32, 128, (1 << 20) + 4)],  # rows 4 bytes off 16-byte alignment
)
def test_forcing_the_tf32x3_kernel_where_the_rule_refuses_raises(monkeypatch, dtype, d, ptr):
    lib = _routing_library(monkeypatch)
    x = _FakeLaunchTensor(dtype, (2, S, 8, d), ptr)
    with pytest.raises(ValueError, match="tf32x3"):
        port._launch(x, x, x, None, 0.1, variant="tf32x3")
    assert lib.calls == [] and port.fused_attention.launches == 0


def test_forcing_the_simple_kernel_on_an_aligned_float32_call(monkeypatch):
    """The simple kernel takes any call: the A/B and the forced cases of
    chip_smoke.py hold it on float32 inputs the rule gives to tf32x3."""
    lib = _routing_library(monkeypatch)
    x = _FakeLaunchTensor(torch.float32, (2, S, 8, 128), 1 << 20)
    port._launch(x, x, x, None, 0.1, variant="simple")
    assert [name for name, _ in lib.calls] == ["simple"]
    assert port.fused_attention.launches_by_variant == {
        "tensor_core": 0, "tf32x3": 0, "simple": 1}


# The float32 tensor-core kernel's precision scheme (3xTF32), emulated in
# plain PyTorch and held to the JAX function in float32 at the tolerance
# the card holds the kernel to (chip_smoke.TOL["float32"]): standard-normal
# float32 inputs, so q, k and v are not tf32-representable.

TF32X3_TOL = 2e-5


def _tf32_rna(x):
    """float32 -> the nearest tf32 (10 mantissa bits), ties away from zero,
    as cvt.rna.tf32.f32 gives: integer rounding of the low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq, a, b, passes):
    """einsum `eq` of a and b on tf32 tensor cores, fp32 accumulate: 3xTF32
    (a_small b_big + a_big b_small + a_big b_big) or a single TF32 product."""
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return torch.einsum(eq, a_big, b_big)
    a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)
    return (torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def _kernel_tile(s, d):
    """Keys per tile of csrc/fused_attention_tf32x3.cu (its C entry's choice)."""
    s16 = -(-s // 16) * 16
    if d <= 64:
        return 128
    if d <= 128:
        return 80 if s16 <= 80 else 64
    return 64 if s16 <= 64 else 32


def _tf32x3_scheme(q, k, v, mask, passes=3, block_k=None):
    """fp32 emulation of csrc/fused_attention_tf32x3.cu: S = Q K^T in
    3xTF32 (`passes` = 1: one TF32 product), `scale` on the fp32 logits, -1e9
    where the mask is 0, an online softmax in base 2 over key tiles of
    `block_k` (the kernel's own by default), P split the same way for PV,
    normalised by the fp32 row sum at the end."""
    qf, kf, vf = (torch.from_numpy(x) for x in (q, k, v))
    b, s, h, d = q.shape
    block_k = block_k or _kernel_tile(s, d)
    scale_log2 = np.float32(1.4426950408889634) * np.float32(1.0 / d ** 0.5)
    fill = torch.tensor(np.float32(-1e9) * np.float32(1.4426950408889634))
    keep = None if mask is None else torch.from_numpy(np.asarray(mask) != 0)
    m = torch.full((b, h, s, 1), -float("inf"))
    l = torch.zeros((b, h, s, 1))
    o = torch.zeros((b, s, h, d))
    for k0 in range(0, s, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        logits = _tf32_product("bqhd,bkhd->bhqk", qf, kt, passes) * scale_log2
        if keep is not None:
            logits = torch.where(keep[:, k0:k0 + block_k], logits, fill)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(logits - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha.permute(0, 2, 1, 3) + _tf32_product("bhqk,bkhd->bqhd", p, vt, passes)
        m = m_new
    return (o / l.permute(0, 2, 1, 3)).numpy()


@pytest.mark.parametrize("block_k", [None, 32])
@pytest.mark.parametrize("name", SCHEME_CASES)
def test_tf32x3_scheme_matches_jax_in_fp32(name, block_k):
    """The kernel's own tile (one tile at these shapes) and 32-key tiles,
    which run the online softmax's rescaling over 2-3 tiles."""
    q, k, v, mask, ref = _scheme_case(name, inputs=_f32_inputs)
    out = _tf32x3_scheme(q, k, v, mask, block_k=block_k)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=TF32X3_TOL, rtol=0)


@pytest.mark.parametrize("name", SCHEME_CASES)
def test_single_tf32_product_is_another_function(name):
    """One TF32 product per operand pair (1xTF32, what a float32 matmul with
    TF32 allowed runs) misses the same bound on the same inputs."""
    q, k, v, mask, ref = _scheme_case(name, inputs=_f32_inputs)
    err = np.abs(_tf32x3_scheme(q, k, v, mask, passes=1) - ref).max()
    assert err > TF32X3_TOL


def test_tf32_rounding_is_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    expected = [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    assert _tf32_rna(x).tolist() == expected
    big = _tf32_rna(x)
    assert torch.equal(big + _tf32_rna(x - big), x)


_FAKE_NVCC = r"""#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:  # compile: ptxas's report on stderr, a large one
    sys.stderr.write(("ptxas info    : Used 255 registers, 0 bytes spill stores " + args[-1] + "\n")
                     * 40000)
time.sleep(0.05)
with open(out, "wb") as f:
    f.write(b"ELF" + out.encode())
"""


def test_concurrent_builds_never_show_a_partial_library_or_report(monkeypatch, tmp_path):
    """Replicas of one fleet build the kernel library at first use, at once:
    each builds in its own temporary directory and renames the library and
    ptxas's report into place, so a reader sees each whole or not at all."""
    import threading

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(port, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(port, "_find_nvcc", lambda: str(nvcc))
    library = port.library_path()
    report = library + ".ptxas.txt"
    full = 40000 * len(port.SOURCES)
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            try:
                with open(report) as f:
                    seen.append(f.read().count("\n"))
            except FileNotFoundError:
                pass

    watcher = threading.Thread(target=reader)
    watcher.start()
    builds = [threading.Thread(target=port.build) for _ in range(4)]
    for t in builds:
        t.start()
    for t in builds:
        t.join(60)
    stop.set()
    watcher.join(10)
    assert not any(t.is_alive() for t in builds) and not watcher.is_alive()
    assert os.path.exists(library) and open(library, "rb").read().startswith(b"ELF")
    with open(report) as f:
        assert f.read().count("\n") == full
    assert set(seen) <= {full}
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(library), os.path.basename(report)])  # no temporary left


# The simple kernel's scheme (csrc/fused_attention.cu), emulated in plain
# PyTorch in fp32 and held to the JAX function: its key tile, one pass or
# an online softmax over tiles, -inf in the tile's slots past s, -1e9 where
# the mask is 0, the result cast to the inputs' dtype. Tolerances as the
# card holds the kernel to (chip_smoke.TOL): 2e-5 in float32, 2e-2 in bf16.

SIMPLE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _simple_tile(s, d):
    """Keys per tile of csrc/fused_attention.cu (its C entry's choice): 32
    keys a lane-slot, up to 4 slots at d <= 64, 3 at d <= 128, 1 above."""
    return 32 * min(-(-s // 32), 4 if d <= 64 else 3 if d <= 128 else 1)


def _simple_scheme(q, k, v, mask, dtype):
    """q/k/v: float32 arrays (bf16-representable for bf16). fp32 products
    of `q * scale` (scaled in fp32 first, as the kernel stages Q) against
    K, then an online softmax in base e over tiles of `_simple_tile` keys,
    the slots past s at -inf and V zero there; acc / l at the end."""
    qf, kf, vf = (torch.from_numpy(x) for x in (q, k, v))
    b, s, h, d = q.shape
    block_k = _simple_tile(s, d)
    qf = qf * np.float32(1.0 / d ** 0.5)
    keep = None if mask is None else torch.from_numpy(np.asarray(mask) != 0)
    m = torch.full((b, h, s, 1), -float("inf"))
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, s, h, d))
    for k0 in range(0, s, block_k):
        kn = min(block_k, s - k0)
        logits = torch.full((b, h, s, block_k), -float("inf"))
        logits[..., :kn] = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + kn])
        if keep is not None:
            logits[..., :kn] = torch.where(keep[:, k0:k0 + kn], logits[..., :kn],
                                           torch.tensor(-1e9, dtype=torch.float32))
        vt = torch.zeros((b, block_k, h, d))
        vt[:, :kn] = vf[:, k0:k0 + kn]
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha.permute(0, 2, 1, 3) + torch.einsum("bhqk,bkhd->bqhd", p, vt)
        m = m_new
    out = acc / l.permute(0, 2, 1, 3)
    return out.to(getattr(torch, dtype)).float().numpy()


# (name, s, d, mask): `tiny`'s shape and mask; the one-pass edges at d = 8
# (s = 1, 32 one slot; 33 two slots; 66 the flagship window, three); head
# dims 1, 40 and 200 (200: 32-key tiles, so three tiles and two rescales).
SIMPLE_CASES = [
    ("tiny", 15, 8, "rt1_tiny"),
    ("s1", 1, 8, "none"),
    ("s32", 32, 8, "causal"),
    ("s33", 33, 8, "causal"),
    ("s66", 66, 8, "rt1"),
    ("d1", 66, 1, "rt1"),
    ("d40", 66, 40, "rt1"),
    ("d200", 66, 200, "rt1"),
    ("tiny_masked_rows", 15, 8, "rt1_tiny_masked_rows"),
]


def _simple_case(seed, s, d, kind, dtype):
    """(q, k, v, mask) as float32 arrays, (2, s, 2, d); bf16-representable
    values for bf16."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, s, 2, d), dtype=np.float32) for _ in range(3))
    if dtype == "bfloat16":
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v))
    if kind == "none":
        mask = None
    elif kind.startswith("rt1_tiny"):
        mask = np.asarray(jax_rt1_mask(3, 2, 3), np.int32).copy()
        if kind.endswith("masked_rows"):
            mask[[0, 7, 14]] = 0
    elif kind == "rt1":
        mask = np.asarray(jax_rt1_mask(6, 8, 3), np.int32)
    else:
        mask = np.tril(np.ones((s, s), np.int32))
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,s,d,kind", SIMPLE_CASES, ids=[c[0] for c in SIMPLE_CASES])
def test_simple_scheme_matches_jax(name, s, d, kind, dtype):
    """Against JAX's Pallas kernel in interpret mode; the fully masked rows
    against dense_attention_reference (the Pallas wrapper's padding
    averages them over its padded keys too)."""
    q, k, v, mask = _simple_case(20 + len(name) + s + d, s, d, kind, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    args = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    jmask = None if mask is None else jnp.asarray(mask)
    if name.endswith("masked_rows"):
        ref = dense_attention_reference(*args, mask=jmask)
    else:
        ref = jax_fused_attention(*args, mask=jmask, interpret=True)
    out = _simple_scheme(q, k, v, mask, dtype)
    assert out.shape == (2, s, 2, d) and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=SIMPLE_TOL[dtype], rtol=0)
    if name.endswith("masked_rows"):
        np.testing.assert_allclose(out[:, [0, 7, 14]],
                                   np.broadcast_to(v.mean(axis=1)[:, None], (2, 3, 2, d)),
                                   atol=SIMPLE_TOL[dtype], rtol=0)

