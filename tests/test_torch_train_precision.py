"""The mixed-precision train step against the JAX package's.

JAX's flagship step (`parallel.mixed_precision`, `model.dtype=bfloat16`)
runs `_loss_fn` on `_bf16_compute_copy(params)`: one bf16 copy of the
float32 masters, with float32 islands — the attention logits and softmax
(`preferred_element_type=float32`), the loss's logsumexp and soft-argmax
softmax over logits upcast to float32, and BatchNorm's batch statistics
(flax's `force_float32_reductions`). The port's step (`TrainStepFns` with
`compute_dtype=bfloat16`) must keep the same islands.

Numbers cannot hold that at a size the CPU runs. On the tiny policy, JAX's
own bf16 gradient differs from its float32 gradient by 0.3 to 4 times the
largest gradient (most leaves sum terms of both signs, and bf16 rounding
decides what is left), and its bf16 loss from its float32 loss by up to
5e-3 relative; an all-bf16 attention softmax moves the port's loss and
gradients by less than that. So the islands are held by their dtypes,
read from both programs: every softmax and logsumexp the port runs in its
bf16 step takes the dtype in which JAX's jaxpr (forward and backward)
runs `exp` at the same shape, float32 for the islands (TokenLearner's
spatial softmax is bf16 on both sides); every BatchNorm call gets float32
statistics and affine parameters (torch's kernel then reduces the bf16
input in float32, its accumulate type), where JAX's jaxpr reduces the
batch in float32. An all-bf16 softmax, a bf16 loss or a bf16 BatchNorm
fails this. Numerically the step is held where bf16 noise allows: on the
tiny policy the loss within 5e-3 relative of JAX's bf16 loss (measured
within 5e-4 over three seeds, focal gamma 2 and the soft-argmax MSE on);
the gradient finite, the masters float32 and moved. The small
EfficientNet's case holds the dtypes only: JAX's tower draws stochastic
depth (fixed at 0.2 there) from its own stream, so the two losses differ
by the draws.
"""

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from rt1_tpu.trainer.train import _bf16_compute_copy, _loss_fn
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import create_train_state
from rt1_tpu_torch.trainer.train import TrainStepFns
from test_torch_train_policy import batch, tiny_pair, to_torch

torch.set_num_threads(2)

LOSS_RTOL = 5e-3


class _Regions(TorchFunctionMode):
    """Records (op, input shape, input dtype) of the port's softmax and
    logsumexp calls, and (input shape, statistics and affine dtypes) of its
    BatchNorm calls."""

    def __init__(self):
        super().__init__()
        self.softmax, self.batch_norm = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.softmax, torch.Tensor.softmax, torch.logsumexp, torch.Tensor.logsumexp):
            self.softmax.append((func.__name__, tuple(args[0].shape), args[0].dtype))
        elif func is torch.nn.functional.batch_norm:
            x, mean, var = args[:3]
            affine = [kwargs.get(k, a) for k, a in zip(("weight", "bias"), args[3:5] + (None,) * 2)]
            self.batch_norm.append((tuple(x.shape), {t.dtype for t in (mean, var, *affine)}))
        return func(*args, **kwargs)


def _jax_eqns(closed):
    """Every equation of `closed`, sub-jaxprs included."""

    def subs(value):
        if hasattr(value, "jaxpr") and hasattr(value, "consts"):
            yield value.jaxpr
        elif hasattr(value, "eqns"):
            yield value
        elif isinstance(value, (tuple, list)):
            for v in value:
                yield from subs(v)

    stack, out = [closed.jaxpr], []
    while stack:
        jaxpr = stack.pop()
        for eqn in jaxpr.eqns:
            out.append(eqn)
            for value in eqn.params.values():
                stack.extend(subs(value))
    return out


@pytest.mark.parametrize("tokenizer", ["tiny", "efficientnet_small"])
def test_bf16_step_keeps_jax_float32_regions(tokenizer):
    overrides = {"dtype": "bfloat16", "focal_gamma": 2.0, "aux_mse_weight": 0.1}
    if tokenizer != "tiny":
        overrides["image_tokenizer"] = tokenizer
    jm, pm, variables = tiny_pair(71, **overrides)
    obs, actions = batch(72)
    batch_stats = variables.get("batch_stats", {})

    def jax_loss(params):
        return _loss_fn(jm, _bf16_compute_copy(params), batch_stats, (obs, actions),
                        jax.random.PRNGKey(0), True)

    grad_fn = jax.value_and_grad(jax_loss, has_aux=True)
    eqns = _jax_eqns(jax.make_jaxpr(grad_fn)(variables["params"]))
    jax_exp = {}
    for eqn in eqns:
        if eqn.primitive.name == "exp":
            for v in eqn.outvars:
                jax_exp.setdefault(tuple(v.aval.shape), set()).add(str(v.aval.dtype))
    (jloss, _), _ = jax.jit(grad_fn)(variables["params"])

    state = create_train_state(pm, Adam())
    before = state.flat.clone()
    fns = TrainStepFns(Adam(), seed=0, compute_dtype=torch.bfloat16)
    regions = _Regions()
    with regions:
        metrics = fns.train_step(state, (to_torch(obs), to_torch(actions)), 0)

    # Every softmax and logsumexp in JAX's dtype at its shape; the islands
    # (attention probabilities, the loss's logsumexp, the soft-argmax) in
    # float32. TokenLearner's spatial softmax is bf16 on both sides.
    s = jm.time_sequence_length * (jm.num_image_tokens + jm.tokens_per_action)
    islands = 0
    for name, shape, dtype in regions.softmax:
        port = str(dtype).split(".")[-1]
        assert jax_exp.get(shape) == {port}, (name, shape, port, jax_exp.get(shape))
        if shape[-2:] == (s, s) or shape[-1] == jm.vocab_size:
            assert port == "float32", (name, shape)
            islands += 1
    assert islands >= jm.num_layers + 2, regions.softmax
    # BatchNorm: float32 statistics where JAX reduces the batch in float32.
    if tokenizer == "tiny":
        assert regions.batch_norm == []
    else:
        assert regions.batch_norm
        reductions = {}
        for eqn in eqns:
            if eqn.primitive.name == "reduce_sum":
                x = eqn.invars[0].aval
                reductions.setdefault(tuple(x.shape), set()).add(str(x.dtype))
        for (n, c, h, w), dtypes in regions.batch_norm:
            assert dtypes == {torch.float32}, ((n, c, h, w), dtypes)
            assert "float32" in reductions.get((n, h, w, c), ()), (n, h, w, c)
    # The numbers bf16 noise leaves to compare (JAX's tower draws its
    # stochastic depth, fixed at 0.2, from its own stream: no loss there).
    if tokenizer == "tiny":
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=LOSS_RTOL)
    assert np.isfinite(metrics["grad_norm"].item()) and metrics["grad_norm"].item() > 0
    assert state.flat.dtype == torch.float32 and not torch.equal(state.flat, before)
