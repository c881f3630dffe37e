"""The data-parallel and ZeRO-3 train step on gloo groups of the CPU.

The config has BatchNorm: `tiny` with the efficientnet_b3 tokenizer at
the tiny config's 32x56 frames, float32, a global batch of 4. One group
of 2 ranks runs, in turn: dp=2 and fsdp=2 (randomness off), dp=2 with
dropout, the crop and stochastic depth on, dp=2 with 2 micro-batches,
LAVA's loss under dp=2, a NaN in rank 1's rows, and the MoE decoder at
bf16 (mixed precision, and the float32 routers without it) under fsdp=2
and dp=2. One group of 4 runs dp=2 x fsdp=2. The references:

* the port's step in one process on the whole global batch: the loss
  within rtol 1e-5; the flat gradient before the Adam update within 1e-5
  of its largest magnitude (LAVA, two steps); through the B3 tower, one
  step, the gradient within 2e-4 of its largest magnitude and the
  BatchNorm running statistics within 5e-5 (`GRAD_TOL_B3`, `STATS_TOL_B3`:
  the world of one against itself with the global batch's rows permuted,
  the same math in another order, differs by 7.1e-5 of the gradient's
  largest magnitude and 1.3e-5 in the statistics, the float32 rounding of
  26 BatchNorm'd blocks; one step, because Adam's first update moves
  every parameter by about sign(g) lr and the gradients BatchNorm cancels
  are rounding noise of either sign); and the parameters after Adam within
  1e-6 wherever the reference gradient exceeds that rounding (its sign is
  settled), within 2 lr elsewhere (a rounding difference may flip
  sign(g) lr, `tests/test_plan.py`'s note);
* JAX's dense step (`rt1_tpu.trainer.train._loss_fn`) at the same
  converted weights, randomness off (JAX's stochastic depth, a module
  default there, patched to the identity for the test): the loss within
  rtol 1e-5, the gradient and the statistics within `GRAD_TOL_B3` and
  `STATS_TOL_B3` (the port's efficientnet train parity holds the 0.35
  tower's gradient within 1e-4 of its largest magnitude,
  `test_torch_train_efficientnet`; the B3 tower's own rounding spread,
  above, is 7.1e-5 of it).

Under accumulation the world of one steps the global batch in the order
whose micro-batch i is every rank's micro-batch i (each rank splits its
own rows). The MoE decoder routes the global batch on every rank (global
capacity and queue order; `models/moe.py`), so its float32 checks hold
dp=2 and fsdp=2 against the world of one within `GRAD_TOL`, the reported
`moe_aux_loss` too, at capacity factor 0.5 (tokens dropped) and aux weight
1 (the load-balancing term's gradient is visible beside the task loss's),
once with remat and dropout on (the recompute re-enters the rank's block);
at bf16 they compare fsdp=2 with dp=2 bit for bit in the loss and the
gradient (the float32 routers' masters gathered under fsdp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu.trainer.train import _loss_fn
from rt1_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.train.train import build_model
from test_torch_rt1 import init_jax
import torch_parallel_worker as worker

torch.set_num_threads(2)

H, W, T, B = 32, 56, 3, 4
B3 = ["model.image_tokenizer=efficientnet_b3"]
OFF = ["model.dropout_rate=0", "regularization.crop_ratio=0",
       "regularization.drop_connect_rate=0"]
HEALTH = OFF + ["obs.model_health=true", "obs.health_group_depth=3"]
LR = worker.OPT["learning_rate"]
GRAD_TOL = 1e-5
GRAD_TOL_B3 = 2e-4
STATS_TOL_B3 = 5e-5


def b3_weights():
    """(JAX model, its variables, the port's state_dict of them)."""
    jcfg = jax_tiny.get_config()
    jcfg.model.image_tokenizer = "efficientnet_b3"
    jm = jax_build_model(jcfg.model).clone(dropout_rate=0.0, crop_ratio=0.0)
    variables = init_jax(jm, T, 7)
    cfg = worker.make_config("tiny", B3 + OFF)
    pm = build_policy(cfg)
    load_flax_variables(pm, variables["params"], variables["batch_stats"])
    return jm, variables, {k: v.clone() for k, v in pm.state_dict().items()}


def seeded_weights(name, overrides, seed=3):
    cfg = worker.make_config(name, overrides + [f"seed={seed}"])
    return {k: v.clone() for k, v in build_model(cfg, "cpu").state_dict().items()}


def batches(n=1, seed=11, b=B, **kw):
    h, w = kw.get("h", H), kw.get("w", W)
    return [worker.global_batch(seed + i, b, T, h, w) for i in range(n)]


def spec(config, overrides, weights, steps=1, **kw):
    return dict(config=config, overrides=overrides, weights=weights,
                batches=kw.pop("batches", None) or batches(steps, **kw), **kw)


@pytest.fixture(scope="module")
def b3():
    return b3_weights()


@pytest.fixture(scope="module")
def group2(b3, tmp_path_factory):
    _, _, weights = b3
    nan_batch = batches(1, seed=31)
    nan_batch[0][0]["image"][B - 1, 0, 0, 0, 0] = np.nan   # rank 1's rows
    moe = ["model.ffn_impl=moe", "model.dtype=bfloat16"]
    moe_weights = seeded_weights("tiny", moe)
    tiny_weights = seeded_weights("tiny", HEALTH)
    lava_weights = seeded_weights("lava_tiny", [])
    moe32 = ["model.ffn_impl=moe", "model.moe_capacity_factor=0.5", "model.moe_aux_weight=1.0",
             "model.dropout_rate=0"]
    moe32_weights = seeded_weights("tiny", moe32)
    checks = {
        "dp": spec("tiny", B3 + OFF + ["parallel.dp=2"], weights),
        "fsdp": spec("tiny", B3 + OFF + ["parallel.fsdp=2"], weights),
        "dp_random": spec("tiny", B3 + ["parallel.dp=2", "regularization.drop_connect_rate=0.2"],
                          weights, steps=1, seed=21),
        "dp_accum": spec("tiny", B3 + OFF + ["parallel.dp=2", "accum_steps=2"], weights),
        "lava": spec("lava_tiny", ["parallel.dp=2"], lava_weights,
                     batches=batches(2, seed=41, h=64, w=64)),
        "guard": spec("tiny", B3 + OFF + ["parallel.dp=2"], weights, batches=nan_batch),
        "moe_mp_fsdp": spec("tiny", moe + ["parallel.fsdp=2", "parallel.mixed_precision=true"],
                            moe_weights, seed=51),
        "moe_mp_dp": spec("tiny", moe + ["parallel.dp=2", "parallel.mixed_precision=true"],
                          moe_weights, seed=51),
        "moe_fsdp": spec("tiny", moe + ["parallel.fsdp=2"], moe_weights, seed=51, routers=True),
        "moe_dp": spec("tiny", moe + ["parallel.dp=2"], moe_weights, seed=51, routers=True),
        "health": spec("tiny", HEALTH + ["parallel.fsdp=2"], tiny_weights, seed=61),
        "moe32_dp": spec("tiny", moe32 + ["parallel.dp=2"], moe32_weights, seed=71),
        "moe32_fsdp": spec("tiny", moe32 + ["parallel.fsdp=2"], moe32_weights, seed=71),
        "moe32_remat_dp": spec("tiny", moe32 + ["parallel.dp=2", "model.remat=true",
                                                "model.dropout_rate=0.1"],
                               moe32_weights, seed=73),
    }
    tmp = tmp_path_factory.mktemp("group2")
    return checks, worker.spawn(2, "step_checks", {"checks": checks}, tmp)


@pytest.fixture(scope="module")
def group4(b3, tmp_path_factory):
    _, _, weights = b3
    checks = {"dp_fsdp": spec("tiny", B3 + OFF + ["parallel.dp=2", "parallel.fsdp=2"],
                              weights)}
    tmp = tmp_path_factory.mktemp("group4")
    return checks, worker.spawn(4, "step_checks", {"checks": checks}, tmp)


def reference(check, overrides=None, **kw):
    """The port's one-process step on the whole global batch."""
    ref = dict(check, **kw)
    ref["overrides"] = [o for o in (overrides or check["overrides"])
                        if not o.startswith("parallel.dp") and not o.startswith("parallel.fsdp")]
    return worker.run_steps(ref, distributed=False)


def assert_matches(got, ref, what, grad_tol=GRAD_TOL_B3):
    for i, (loss, rloss) in enumerate(zip(got["losses"], ref["losses"])):
        np.testing.assert_allclose(loss.item(), rloss.item(), rtol=1e-5, err_msg=f"{what} loss {i}")
        grad, rgrad = got["grads"][i].numpy(), ref["grads"][i].numpy()
        scale = np.abs(rgrad).max()
        np.testing.assert_allclose(grad, rgrad, atol=grad_tol * scale, rtol=0,
                                   err_msg=f"{what} grad {i}")
        np.testing.assert_allclose(got["grad_norms"][i].item(), ref["grad_norms"][i].item(),
                                   rtol=1e-5, err_msg=f"{what} grad norm {i}")
        if ref["action_loss_mean"]:  # a rank-local value before the fix
            np.testing.assert_allclose(got["action_loss_mean"][i].item(),
                                       ref["action_loss_mean"][i].item(), rtol=1e-5,
                                       err_msg=f"{what} action_loss_mean {i}")
    np.testing.assert_allclose(got["state"]["buffers"].numpy(), ref["state"]["buffers"].numpy(),
                               atol=STATS_TOL_B3, rtol=0, err_msg=f"{what} BatchNorm statistics")
    flat, rflat = got["state"]["flat"].numpy(), ref["state"]["flat"].numpy()
    rgrad = np.abs(ref["grads"][-1].numpy())
    settled = rgrad > grad_tol * rgrad.max()
    diff = np.abs(flat.astype(np.float64) - rflat)
    assert (diff[settled] <= 1e-6).all(), (what, diff[settled].max())
    assert (diff <= 2 * LR * (1 + 1e-3)).all(), (what, diff.max())
    assert got["state"]["step"] == ref["state"]["step"]


@pytest.mark.parametrize("name", ["dp", "fsdp", "dp_random", "dp_accum", "lava"])
def test_two_ranks_match_the_world_of_one(group2, name):
    checks, results = group2
    check = checks[name]
    kw = {}
    if name == "dp_accum":  # micro-batch i of the world of one: each rank's micro-batch i
        kw["order"] = [0, 2, 1, 3]
    ref = reference(check, **kw)
    for rank, res in enumerate(results):
        assert_matches(res[name], ref, f"{name} rank {rank}",
                       GRAD_TOL if name == "lava" else GRAD_TOL_B3)
    if name == "fsdp":
        assert results[0][name]["flat_dtype"] == "torch.float32"
        assert results[0][name]["flat_numel"] * 2 >= ref["state"]["flat"].numel()
        assert results[0][name]["flat_numel"] < ref["state"]["flat"].numel()


def test_four_ranks_dp_by_fsdp_match_the_world_of_one(group4):
    checks, results = group4
    ref = reference(checks["dp_fsdp"])
    seen = set()
    for rank, res in enumerate(results):
        assert_matches(res["dp_fsdp"], ref, f"dp x fsdp rank {rank}")
        seen.add(res["dp_fsdp"]["grid"]["batch_index"])
    assert seen == {0, 1, 2, 3}


def _jax_step(jm, variables, batch):
    def loss(params):
        return _loss_fn(jm, params, variables["batch_stats"], batch, jax.random.PRNGKey(0), True)

    (value, (_, new_bs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return value, grads, new_bs


def test_two_and_four_ranks_match_jax_dense_step(b3, group2, group4, monkeypatch):
    """The first step's loss, gradient and statistics against JAX's dense
    step on the global batch."""
    import rt1_tpu.models.efficientnet as jax_efficientnet

    monkeypatch.setattr(jax_efficientnet, "stochastic_depth",
                        lambda x, rate, deterministic, rng: x)
    jm, variables, _ = b3
    checks, results = group2
    assert len(checks["dp"]["batches"]) == 1
    obs, actions = checks["dp"]["batches"][0]
    jloss, jgrads, jstats = _jax_step(jm, variables, (obs, actions))
    ref_grads = state_dict_from_flax(jax.device_get(jgrads))
    ref_stats = state_dict_from_flax({}, jax.device_get(jstats))
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    cfg = worker.make_config("tiny", B3 + OFF)
    layout_policy = build_policy(cfg)
    from rt1_tpu_torch.trainer.state import FlatLayout, floating_buffers

    names = [n for n, _ in layout_policy.named_parameters()]
    layout = FlatLayout([p for _, p in layout_policy.named_parameters()])
    buffer_names = [n for n, b in layout_policy.named_buffers() if b.is_floating_point()]
    buffer_layout = FlatLayout(floating_buffers(layout_policy))
    for name, res in [("dp", results[0]["dp"]), ("fsdp", results[1]["fsdp"]),
                      ("dp_fsdp", group4[1][3]["dp_fsdp"])]:
        np.testing.assert_allclose(res["losses"][0].item(), float(jloss), rtol=1e-5,
                                   err_msg=f"{name} loss")
        grads = dict(zip(names, layout.views(res["grads"][0])))
        assert set(grads) == set(ref_grads)
        for key, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref_grads[key].numpy(), atol=GRAD_TOL_B3 * scale,
                                       rtol=0, err_msg=f"{name} grad {key}")
    for name, res in [("dp", results[0]["dp"]), ("dp_fsdp", group4[1][3]["dp_fsdp"])]:
        stats = dict(zip(buffer_names, buffer_layout.views(res["state"]["buffers"])))
        assert ref_stats and set(ref_stats) <= set(stats)
        for key, value in ref_stats.items():
            np.testing.assert_allclose(stats[key].numpy(), value.numpy(), atol=STATS_TOL_B3,
                                       rtol=0, err_msg=f"{name} stats {key}")


def test_fsdp_health_pack_reads_global_values(group2):
    """The pack's gradient, update and parameter norms by group (squared
    sums of the chunks summed over the fsdp ranks) and its action
    statistics (over both ranks' rows) equal the world of one's."""
    checks, results = group2
    ref = reference(checks["health"])
    names = ref["pack_names"]
    assert len(names) > 8 and any(n.startswith("health/grad_norm/") for n in names)
    for rank, res in enumerate(results):
        got = res["health"]
        assert got["pack_names"] == names
        assert_matches(got, ref, f"health rank {rank}", GRAD_TOL)
        np.testing.assert_allclose(got["packs"][0].numpy(), ref["packs"][0].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=f"health pack rank {rank}")


def test_a_nan_in_one_ranks_rows_skips_every_rank(group2):
    checks, results = group2
    ref = reference(checks["guard"])
    assert ref["state"]["guard_skips"] == 1 and ref["state"]["step"] == 0
    for res in results:
        state = res["guard"]["state"]
        assert state["guard_skips"] == 1 and state["step"] == 0 and state["count"] == 0
        assert not np.isfinite(res["guard"]["losses"][0].item())
        assert torch.equal(state["flat"], ref["state"]["flat"])  # untouched, bit for bit
        assert torch.equal(state["buffers"], ref["state"]["buffers"])


@pytest.mark.parametrize("name", ["moe32_dp", "moe32_fsdp", "moe32_remat_dp"])
def test_moe_ranks_route_the_global_batch_as_the_world_of_one(group2, name):
    """Global capacity and queue order, and the load-balancing loss at its
    full weight: per-rank routing, or an aux term divided with the task
    loss's W x W, fails here."""
    checks, results = group2
    ref = reference(checks[name])
    assert len(ref["moe_aux_loss"]) == 1
    for rank, res in enumerate(results):
        got = res[name]
        assert_matches(got, ref, f"{name} rank {rank}", GRAD_TOL)
        np.testing.assert_allclose(got["moe_aux_loss"][0].item(), ref["moe_aux_loss"][0].item(),
                                   rtol=1e-5, err_msg=f"{name} moe_aux_loss rank {rank}")


def test_moe_fsdp_equals_dp_bit_for_bit_with_float32_masters_and_routers(group2):
    _, results = group2
    for res in results:
        for a, b in [("moe_mp_fsdp", "moe_mp_dp"), ("moe_fsdp", "moe_dp")]:
            assert res[a]["flat_dtype"] == "torch.float32"
            assert torch.equal(res[a]["losses"][0], res[b]["losses"][0]), a
            assert torch.equal(res[a]["grads"][0], res[b]["grads"][0]), a
        routers = res["moe_fsdp"]["routers"]
        assert routers and set(routers) == set(res["moe_dp"]["routers"])
        for name, tensor in routers.items():
            assert tensor.dtype == torch.float32
            assert torch.equal(tensor, res["moe_dp"]["routers"][name]), name
        # The mixed-precision step computes the routers from bf16, as JAX's
        # `_bf16_compute_copy` casts every leaf: none are kept float32.
        assert np.isfinite(res["moe_mp_fsdp"]["losses"][0].item())
