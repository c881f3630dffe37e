"""Ring attention over gloo groups of 2 and 4 ranks on the CPU.

The port's `ring_attention` (`rt1_tpu_torch/parallel/ring_attention.py`)
at S = 2 and S = 4 on JAX's test shapes (b 2, t 32, 4 heads of 16):
without a mask, causal, the RT-1 mask (2 frames of 13 image and 3 action
tokens) and with a fully masked row; the output against JAX's
`ring_attention` on the forced CPU mesh of the same seq size and against
`dense_attention_reference`, and the gradients of sum(out * cot) in q, k
and v against dense attention's (torch autograd), all float32 within
1e-5. A window that does not divide raises. The RT-1 policy (`tiny`,
window 4: 20 tokens) with `attention_impl="ring"` at sp = S gives the
dense policy's eval and train losses and gradients (JAX's
`test_rt1_policy_ring_matches_dense` at sp 8), within 1e-5, and two
train steps under `parallel.sp` = S (every seq rank on the whole batch)
give the one-process step's losses, gradients and parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.models.rt1 import rt1_attention_mask
from rt1_tpu.parallel import MeshConfig, make_mesh
from rt1_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from rt1_tpu_torch.parallel.ring_attention import dense_attention_reference
from rt1_tpu_torch.train.train import build_model
import torch_parallel_worker as worker

torch.set_num_threads(2)

B, T, H, D = 2, 32, 4, 16
TOL = 1e-5
POLICY = ["model.time_sequence_length=4", "model.dropout_rate=0", "regularization.crop_ratio=0"]


def cases():
    rng = np.random.default_rng(0)
    masks = {
        "none": None,
        "causal": np.tril(np.ones((T, T), np.int32)),
        "rt1": np.asarray(rt1_attention_mask(time_sequence_length=2, tokens_per_image=13,
                                             tokens_per_action=3), np.int32),
        "fully_masked_row": np.concatenate(
            [np.zeros((1, T), np.int32), np.ones((T - 1, T), np.int32)]),
    }
    out = {}
    for name, mask in masks.items():
        q, k, v, cot = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))
        out[name] = dict(q=q, k=k, v=v, cot=cot, mask=mask)
    return out


def dense_with_grads(case):
    q, k, v = (torch.from_numpy(case[x]).requires_grad_(True) for x in ("q", "k", "v"))
    mask = torch.from_numpy(case["mask"]) if case["mask"] is not None else None
    y = dense_attention_reference(q, k, v, mask=mask)
    (y * torch.from_numpy(case["cot"])).sum().backward()
    return {"out": y.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def policy_spec(sp):
    cfg = worker.make_config("tiny", POLICY)
    weights = {k: v.clone() for k, v in build_model(cfg, "cpu").state_dict().items()}
    return dict(config="tiny", overrides=POLICY + ["model.attention_impl=ring", f"parallel.sp={sp}"],
                weights=weights, batch=worker.global_batch(3, 2, 4, 32, 56))


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def ring(request, tmp_path_factory):
    size = request.param
    all_cases = cases()
    policy = policy_spec(size)
    step = dict(config="tiny", overrides=policy["overrides"], weights=policy["weights"],
                batches=[worker.global_batch(4 + i, 4, 4, 32, 56) for i in range(2)])
    payload = {"cases": all_cases, "policy": policy, "step": step}
    results = worker.spawn(size, "ring_checks", payload, tmp_path_factory.mktemp(f"ring{size}"))
    return size, all_cases, payload, results


def test_ring_matches_jax_ring_and_dense_with_gradients(ring):
    size, all_cases, _, results = ring
    mesh = make_mesh(MeshConfig(data=1, seq=size, model=1), devices=jax.devices()[:size])
    for name, case in all_cases.items():
        dense = dense_with_grads(case)
        mask = jnp.asarray(case["mask"]) if case["mask"] is not None else None
        jout = np.asarray(jax_ring_attention(jnp.asarray(case["q"]), jnp.asarray(case["k"]),
                                             jnp.asarray(case["v"]), mesh, mask=mask,
                                             batch_axis=None))
        for rank, res in enumerate(results):
            got = res[name]
            assert np.isfinite(got["out"].numpy()).all()
            np.testing.assert_allclose(got["out"].numpy(), jout, atol=TOL, rtol=0,
                                       err_msg=f"{name} rank {rank} vs JAX ring")
            for key in ("out", "dq", "dk", "dv"):
                np.testing.assert_allclose(got[key].numpy(), dense[key].numpy(), atol=TOL,
                                           rtol=0, err_msg=f"{name} rank {rank} {key} vs dense")


def test_ring_refuses_a_window_it_cannot_split(ring):
    size, _, _, results = ring
    for res in results:
        assert res["indivisible"] == f"seq len {3 * size + 1} not divisible by seq={size}"


def test_rt1_policy_ring_matches_dense(ring):
    size, _, payload, results = ring
    spec = payload["policy"]
    cfg = worker.make_config("tiny", POLICY)
    dense = build_model(cfg, "cpu")
    dense.load_state_dict(spec["weights"])
    obs, actions = worker.rows(spec["batch"], 0, 1)
    with torch.no_grad():
        eval_loss = dense(obs, actions, train=False)["loss"]
    loss = dense(obs, actions, train=True, rngs={})["loss"]
    loss.backward()
    for rank, res in enumerate(results):
        got = res["policy"]
        assert got["ring_calls"] == 2 * cfg.model.num_layers   # every layer, eval and train
        np.testing.assert_allclose(got["eval_loss"].item(), eval_loss.item(), rtol=TOL)
        np.testing.assert_allclose(got["train_loss"].item(), loss.item(), rtol=TOL)
        scale = max(p.grad.abs().max().item() for p in dense.parameters())
        for name, p in dense.named_parameters():
            np.testing.assert_allclose(got["grads"][name].numpy(), p.grad.numpy(),
                                       atol=TOL * scale, rtol=0,
                                       err_msg=f"sp={size} rank {rank} grad {name}")


def test_sp_train_steps_equal_the_world_of_one(ring):
    size, _, payload, results = ring
    ref = worker.run_steps(payload["step"], distributed=False)
    for rank, res in enumerate(results):
        got = res["step"]
        assert got["grid"]["coords"]["seq"] == rank and got["grid"]["batch_index"] == 0
        for i, (loss, rloss) in enumerate(zip(got["losses"], ref["losses"])):
            np.testing.assert_allclose(loss.item(), rloss.item(), rtol=TOL,
                                       err_msg=f"sp={size} rank {rank} loss {i}")
            scale = ref["grads"][i].abs().max().item()
            np.testing.assert_allclose(got["grads"][i].numpy(), ref["grads"][i].numpy(),
                                       atol=TOL * scale, rtol=0,
                                       err_msg=f"sp={size} rank {rank} grad {i}")
        # Adam's first step moves a parameter by about sign(g) lr: 1e-6 where
        # the gradient's sign is settled, 2 lr where it is rounding noise
        # (the key bias's true gradient is 0).
        grad = np.abs(ref["grads"][-1].numpy())
        settled = grad > TOL * grad.max()
        diff = np.abs(got["state"]["flat"].numpy().astype(np.float64) - ref["state"]["flat"].numpy())
        assert (diff[settled] <= 1e-6).all(), (size, rank, diff[settled].max())
        assert (diff <= 2 * worker.OPT["learning_rate"] * (1 + 1e-3)).all(), (size, rank)
