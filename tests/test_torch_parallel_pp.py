"""Pipeline parallelism (`parallel.pp`) on gloo groups of the CPU.

`pipeline_apply` (GPipe over the `stage` ranks, point to point) against
the sequential fold of the same stacked layers, JAX's `tests/
test_pipeline.py` cases: (stages, microbatches) = (2, 4), (4, 2) and
(4, 4) on 8 layers of width 16, a data x stage grid (each data row
pipelines its own rows), and the gradients of sum(out ** 2) in the input
and in the stack; the sequential fold is held to JAX's `lax.scan` of the
same stage function. Outputs and input gradients within atol 1e-5 on
every rank, stack gradients (each stage holds its own layers' rows, zero
elsewhere) within 1e-4, JAX's tolerances.

The RT-1 policy with its decoder's layers split over 2 stages
(`parallel/partition.py`, `pp_causal_transformer_apply`): eval-mode
action logits against JAX's sequential `CausalTransformer` inside its
policy on converted weights (the dense and, at capacity factor 4.0 so no
expert overflows, the MoE decoder; within 1e-5 of the largest logit), and
the train step at dropout 0 against the world of one at the tolerances of
`test_torch_parallel_step.py` (pp=2 with the B3 tower, dp2 x pp2, pp2
with remat, tp2 x pp2). With dropout the step runs, equal on both stage
ranks, with a mask per (layer, microbatch, data shard) (JAX's contract:
equal in distribution to the sequential module's, not bit for bit).
JAX's refusals are kept by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.convert import load_flax_variables
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.models.transformer import CausalTransformer
from rt1_tpu_torch.parallel import pipeline
from rt1_tpu_torch.parallel.mesh import RankGrid
from rt1_tpu_torch.parallel.partition import partition_policy
from rt1_tpu_torch.parallel.plan import ShardingPlan
from test_torch_parallel_step import (B3, GRAD_TOL, GRAD_TOL_B3, OFF, assert_matches,
                                      b3_weights, seeded_weights, spec)
from test_torch_rt1 import init_jax
import torch_parallel_worker as worker

torch.set_num_threads(2)

PP2 = ["parallel.pp=2", "model.pipeline_microbatches=2"]
TINY_OFF = ["model.dropout_rate=0", "regularization.crop_ratio=0"]
MOE = ["model.ffn_impl=moe", "model.moe_capacity_factor=4.0"]


def stacked_dense(seed, layers, width):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((layers, width, width)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((layers, width)) * 0.1).astype(np.float32)}


def case(seed, stages, microbatches, layers=8, width=16, rows=8, data=1):
    x = np.random.default_rng(seed + 1).standard_normal((rows, width)).astype(np.float32)
    return dict(stages=stages, microbatches=microbatches, data=data, x=x,
                params=stacked_dense(seed, layers, width))


def sequential(params, x):
    """(out, d sum(out^2)/dx, d/dstack) of the fold in one process."""
    stacked = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pipeline.pipeline_apply(worker.dense_stage_fn, stacked, xt)
    (y ** 2).sum().backward()
    return y.detach(), xt.grad, {k: v.grad for k, v in stacked.items()}


def jax_weights(overrides=()):
    """(JAX tiny model without randomness, its variables, the port's
    state_dict of them) at `overrides` of the model config."""
    jcfg = jax_tiny.get_config()
    for key, value in overrides:
        setattr(jcfg.model, key, value)
    jm = jax_build_model(jcfg.model).clone(dropout_rate=0.0, crop_ratio=0.0)
    variables = init_jax(jm, 3, 29)
    cfg = worker.make_config("tiny", TINY_OFF + [f"model.{k}={v}" for k, v in overrides])
    pm = build_policy(cfg)
    load_flax_variables(pm, variables["params"], variables.get("batch_stats"))
    return jm, variables, {k: v.clone() for k, v in pm.state_dict().items()}


@pytest.fixture(scope="module")
def b3():
    return b3_weights()


@pytest.fixture(scope="module")
def jax_runs():
    return {"dense": jax_weights(), "moe": jax_weights([("ffn_impl", "moe"),
                                                       ("moe_capacity_factor", 4.0)])}


@pytest.fixture(scope="module")
def pp2(b3, jax_runs, tmp_path_factory):
    _, _, weights = b3
    dropout = ["model.dropout_rate=0.1"]
    logit_batch = worker.global_batch(101, 4, 3, 32, 56)
    payload = {
        "cases": {"2_4": case(0, 2, 4)},
        "checks": {
            "pp": spec("tiny", B3 + OFF + PP2, weights),
            "pp_remat": spec("tiny", OFF + PP2 + ["model.remat=true"],
                             seeded_weights("tiny", OFF), seed=113),
            "pp_dropout": spec("tiny", dropout + PP2, seeded_weights("tiny", dropout), seed=115),
        },
        "logits": {
            name: dict(config="tiny", overrides=TINY_OFF + PP2 + (MOE if name == "moe" else []),
                       weights=run[2], batch=logit_batch)
            for name, run in jax_runs.items()},
    }
    return payload, worker.spawn(2, "pipeline_checks", payload, tmp_path_factory.mktemp("pp2"))


@pytest.fixture(scope="module")
def pp4(b3, tmp_path_factory):
    _, _, weights = b3
    payload = {
        "cases": {"4_2": case(1, 4, 2), "4_4": case(2, 4, 4),
                  "grads_4_2": case(3, 4, 2, layers=4, width=8, rows=4),
                  "data2_stage2": case(4, 2, 2, layers=4, width=8, rows=8, data=2)},
        "checks": {
            "dp_pp": spec("tiny", B3 + OFF + PP2 + ["parallel.dp=2"], weights),
            "tp_pp": spec("tiny", OFF + PP2 + ["parallel.tp=2"], seeded_weights("tiny", OFF),
                          seed=117),
        },
    }
    return payload, worker.spawn(4, "pipeline_checks", payload, tmp_path_factory.mktemp("pp4"))


def _jax_sequential(params, x):
    def fold(h, p):
        return jnp.tanh(h @ p["w"] + p["b"]), None

    return np.asarray(jax.lax.scan(fold, jnp.asarray(x), params)[0])


@pytest.mark.parametrize("group,name", [("pp2", "2_4"), ("pp4", "4_2"), ("pp4", "4_4"),
                                        ("pp4", "grads_4_2"), ("pp4", "data2_stage2")])
def test_pipeline_matches_sequential(request, group, name):
    payload, results = request.getfixturevalue(group)
    c = payload["cases"][name]
    y, dx, grads = sequential(c["params"], c["x"])
    np.testing.assert_allclose(y.numpy(), _jax_sequential(c["params"], c["x"]), atol=1e-5)
    per_stage = c["params"]["w"].shape[0] // c["stages"]
    n = c["x"].shape[0] // c["data"]
    summed = {k: torch.zeros_like(v) for k, v in grads.items()}
    for res in results:
        got = res[name]
        d, s = got["coords"]["data"], got["coords"]["stage"]
        rows = slice(d * n, (d + 1) * n)
        np.testing.assert_allclose(got["y"].numpy(), y[rows].numpy(), atol=1e-5)
        np.testing.assert_allclose(got["dx"].numpy(), dx[rows].numpy(), atol=1e-5)
        for k, g in got["grads"].items():
            own = slice(s * per_stage, (s + 1) * per_stage)
            assert not g[:own.start].any() and not g[own.stop:].any(), (name, k, s)
            summed[k] += g
    for k, g in grads.items():   # every stage's own layers, every data row's share
        np.testing.assert_allclose(summed[k].numpy(), g.numpy(), atol=1e-4, err_msg=k)


def test_single_stage_degenerates_to_a_loop_and_stack_round_trips():
    c = case(5, 1, 1, layers=3, width=8)
    got = pipeline.pipeline_apply(worker.dense_stage_fn,
                                  {k: torch.from_numpy(v) for k, v in c["params"].items()},
                                  torch.from_numpy(c["x"]), num_microbatches=1)
    np.testing.assert_allclose(got.numpy(), _jax_sequential(c["params"], c["x"]), atol=1e-6)
    t = CausalTransformer(input_emb=8, num_layers=2, key_dim=4, num_heads=2, d_model=8,
                          vocab_size=16)
    params = t.state_dict()
    stacked = pipeline.stack_layer_params(params, 2)
    assert stacked["attn.query.weight"].shape == (2, 8, 8)
    back = pipeline.unstack_layer_params(stacked)
    assert set(back) == {k for k in params if k.startswith("layer_")}
    for key, value in back.items():
        assert torch.equal(value, params[key]), key


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_pipelined_policy_logits_match_jax_sequential_decoder(jax_runs, pp2, name):
    payload, results = pp2
    jm, variables, _ = jax_runs[name]
    obs, actions = payload["logits"][name]["batch"]
    want = np.asarray(jm.apply(variables, obs, actions, train=False)["action_logits"])
    scale = np.abs(want).max()
    for res in results:
        np.testing.assert_allclose(res[name].numpy(), want, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("group,name,tol", [("pp2", "pp", GRAD_TOL_B3),
                                            ("pp2", "pp_remat", GRAD_TOL),
                                            ("pp4", "dp_pp", GRAD_TOL_B3),
                                            ("pp4", "tp_pp", GRAD_TOL)])
def test_pipeline_steps_match_the_world_of_one(request, group, name, tol):
    payload, results = request.getfixturevalue(group)
    check = payload["checks"][name]
    keep = [o for o in check["overrides"] if not o.startswith("parallel.")]
    ref = worker.run_steps(dict(check, overrides=keep), distributed=False)
    got = worker.logical_result(results, name)
    for res in results:
        assert [x.item() for x in res[name]["losses"]] == [x.item() for x in got["losses"]]
    assert_matches(got, ref, name, tol)
    layers = got["partition"]["stage_of"]
    assert layers and set(layers.values()) == {0, 1}


def test_dropout_runs_under_the_pipeline_with_a_mask_per_layer_and_microbatch(pp2):
    payload, results = pp2
    losses = [res["pp_dropout"]["losses"][0].item() for res in results]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    draws = {}
    for layer in (0, 1):
        for micro in (0, 1):
            for shard in (0, 1):
                g = pipeline._layer_rngs(1234, layer, micro, shard, "cpu")["dropout"]
                draws[(layer, micro, shard)] = torch.rand(64, generator=g)
    keys = list(draws)
    for i, a in enumerate(keys):
        assert torch.equal(draws[a], torch.rand(64, generator=pipeline._layer_rngs(
            1234, *a, "cpu")["dropout"]))   # repeatable (a remat recompute draws it again)
        for b in keys[i + 1:]:
            assert not torch.equal(draws[a], draws[b]), (a, b)


def _staged_transformer(**kw):
    t = CausalTransformer(input_emb=8, num_layers=2, key_dim=4, num_heads=2, d_model=8,
                          vocab_size=16, **kw)
    t.stages = pipeline.StagePlan(group=None, index=0, ways=2, layers=range(0, 1),
                                  microbatches=2)
    return t


def test_jax_refusals_are_kept_by_name(fake_world_size):
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="supports attention_impl='dense' only"):
        _staged_transformer(attention_impl="fused")(x)
    with pytest.raises(ValueError, match="pipeline parallelism \\+ MoE FFN is unsupported"):
        _staged_transformer(ffn_impl="moe")(x, train=True, rngs={})
    with pytest.raises(ValueError, match="requires dropout_rng"):
        _staged_transformer(dropout_rate=0.1)(x, train=True, rngs=None)
    plan = pipeline.StagePlan(group=None, index=0, ways=2, layers=range(1), microbatches=3)
    with pytest.raises(ValueError, match="per-shard batch 4 not divisible by "
                                         "num_microbatches=3"):
        pipeline.run_pipeline(lambda h, m: h, plan, torch.zeros(4, 2), [])
    with pytest.raises(ValueError, match="8 stacked layers not divisible by 3 stages"):
        pipeline.pipeline_apply(worker.dense_stage_fn,
                                {k: torch.from_numpy(v) for k, v in stacked_dense(0, 8, 4).items()},
                                torch.zeros(3, 4), group=_FakeGroup(3))
    cfg = worker.make_config("tiny", ["parallel.pp=4"])
    plan4 = ShardingPlan.from_config(cfg, n_devices=4)
    with pytest.raises(ValueError, match="2 stacked layers not divisible by 4 stages"):
        partition_policy(build_policy(cfg), RankGrid(plan4.mesh, rank=0, world=4), plan4)


class _FakeGroup:
    def __init__(self, size):
        self.size = size


@pytest.fixture
def fake_world_size(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: group.size)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)


def test_trainer_seams_refuse_as_jax():
    from rt1_tpu_torch.train.train import check_batch_plan

    lava = worker.make_config("lava_tiny", PP2)
    with pytest.raises(ValueError, match="only supported for the 'rt1' family"):
        check_batch_plan(lava, ShardingPlan.from_config(lava, n_devices=2))
    cfg = worker.make_config("tiny", PP2 + ["model.pipeline_microbatches=3"])
    with pytest.raises(ValueError, match="positive multiple of pipeline_microbatches=3"):
        check_batch_plan(cfg, ShardingPlan.from_config(cfg, n_devices=2))
    cfg = worker.make_config("tiny", PP2 + ["accum_steps=2"])
    check_batch_plan(cfg, ShardingPlan.from_config(cfg, n_devices=2))   # 8 / 2 rows = 2 x 2
