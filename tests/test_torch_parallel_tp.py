"""Tensor parallelism (`parallel.tp`) on gloo groups of the CPU.

Each rank keeps its `model` block of the plan's split leaves
(`parallel/partition.py`): the attention's heads, the FFN's, the token
embedding's and the head's columns, the MoE's experts. One group of 2
ranks runs tp=2 with the efficientnet_b3 tokenizer (BatchNorm), tp=2 with
dropout on (attention dropout keeps the rank's heads of the whole mask),
the MoE decoder at capacity factor 0.5 (tokens dropped) and aux weight 1,
and the health pack. One group of 4 runs dp2 x tp2 and fsdp2 x tp2 (B3),
sp2 x tp2 (the ring on the rank's heads) and dp2 x tp2 on weights
converted from JAX. The references, at the tolerances of
`test_torch_parallel_step.py` (whose `assert_matches` these reuse):

* the port's step in one process on the whole global batch, the ranks'
  parts assembled into the world of one's layout
  (`torch_parallel_worker.logical_result`): the loss within rtol 1e-5,
  the flat float32 gradient within `GRAD_TOL` (or `GRAD_TOL_B3` through
  the B3 tower) of its largest magnitude, the gradient norm within rtol
  1e-5 (its squares summed over `model` for split leaves, once for whole
  ones), the BatchNorm statistics within `STATS_TOL_B3`, the masters after
  Adam where the gradient settles them (1e-6), else within 2 lr; the MoE's
  `moe_aux_loss` within rtol 1e-5 (counted once, not tp times);
* JAX's `make_train_step_fns` on a `MeshConfig(data=2, model=2)` mesh of
  host devices, SGD(1e-2) (JAX's `tests/test_plan.py` yardstick, which
  uses SGD because Adam's first step amplifies rounding to +-lr): the loss
  within rtol 1e-5 and the port's params after the same SGD step,
  computed from its gradient, within atol 1e-5, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rt1_tpu.parallel import MeshConfig as JaxMeshConfig
from rt1_tpu.parallel import make_mesh
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu.trainer.state import TrainState as JaxTrainState
from rt1_tpu.trainer.train import make_train_step_fns
from rt1_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.parallel.mesh import RankGrid
from rt1_tpu_torch.parallel.partition import partition_policy
from rt1_tpu_torch.parallel.plan import ShardingPlan
from test_torch_parallel_step import (B3, GRAD_TOL, GRAD_TOL_B3, HEALTH, OFF, assert_matches,
                                      b3_weights, seeded_weights, spec)
from test_torch_rt1 import init_jax
import torch_parallel_worker as worker

torch.set_num_threads(2)

MOE32 = ["model.ffn_impl=moe", "model.moe_capacity_factor=0.5", "model.moe_aux_weight=1.0",
         "model.dropout_rate=0"]
RING = OFF + ["model.time_sequence_length=4", "model.attention_impl=ring"]
TINY_OFF = ["model.dropout_rate=0", "regularization.crop_ratio=0"]
SGD_LR = 1e-2


def jax_tiny_weights():
    """(JAX tiny model without randomness, its variables, the port's
    state_dict of them)."""
    jm = jax_build_model(jax_tiny.get_config().model).clone(dropout_rate=0.0, crop_ratio=0.0)
    variables = init_jax(jm, 3, 17)
    pm = build_policy(worker.make_config("tiny", TINY_OFF))
    load_flax_variables(pm, variables["params"], variables.get("batch_stats"))
    return jm, variables, {k: v.clone() for k, v in pm.state_dict().items()}


@pytest.fixture(scope="module")
def b3():
    return b3_weights()


@pytest.fixture(scope="module")
def jax_tiny_run():
    return jax_tiny_weights()


@pytest.fixture(scope="module")
def tp2(b3, tmp_path_factory):
    _, _, weights = b3
    dropout = ["model.dropout_rate=0.2"]
    checks = {
        "tp": spec("tiny", B3 + OFF + ["parallel.tp=2"], weights),
        "tp_dropout": spec("tiny", dropout + ["parallel.tp=2"],
                           seeded_weights("tiny", dropout), steps=2, seed=23),
        "moe_tp": spec("tiny", MOE32 + ["parallel.tp=2"], seeded_weights("tiny", MOE32),
                       seed=71),
        "health_tp": spec("tiny", HEALTH + ["parallel.tp=2"], seeded_weights("tiny", HEALTH),
                          seed=61),
    }
    return checks, worker.spawn(2, "step_checks", {"checks": checks},
                                tmp_path_factory.mktemp("tp2"))


@pytest.fixture(scope="module")
def tp4(b3, jax_tiny_run, tmp_path_factory):
    _, _, weights = b3
    checks = {
        "dp_tp": spec("tiny", B3 + OFF + ["parallel.dp=2", "parallel.tp=2"], weights),
        "fsdp_tp": spec("tiny", B3 + OFF + ["parallel.fsdp=2", "parallel.tp=2"], weights),
        "sp_tp": spec("tiny", RING + ["parallel.sp=2", "parallel.tp=2"],
                      seeded_weights("tiny", RING),
                      batches=[worker.global_batch(81, 2, 4, 32, 56)]),
        "jax_tp": spec("tiny", TINY_OFF + ["parallel.dp=2", "parallel.tp=2"], jax_tiny_run[2],
                       seed=91),
    }
    return checks, worker.spawn(4, "step_checks", {"checks": checks},
                                tmp_path_factory.mktemp("tp4"))


def reference(check):
    """The port's one-process step on the whole global batch."""
    keep = [o for o in check["overrides"] if not o.startswith("parallel.")
            or o.startswith("parallel.mixed")]
    if "model.attention_impl=ring" in keep:   # the ring at sp 1 is dense attention
        keep.remove("model.attention_impl=ring")
    return worker.run_steps(dict(check, overrides=keep), distributed=False)


@pytest.mark.parametrize("group,name,tol", [
    ("tp2", "tp", GRAD_TOL_B3), ("tp2", "tp_dropout", GRAD_TOL), ("tp2", "moe_tp", GRAD_TOL),
    ("tp4", "dp_tp", GRAD_TOL_B3), ("tp4", "fsdp_tp", GRAD_TOL_B3), ("tp4", "sp_tp", GRAD_TOL)])
def test_tensor_parallel_steps_match_the_world_of_one(request, group, name, tol):
    checks, results = request.getfixturevalue(group)
    ref = reference(checks[name])
    got = worker.logical_result(results, name)
    for rank, res in enumerate(results):
        assert res[name]["grid"]["coords"]["model"] == rank % 2
        np.testing.assert_array_equal([x.item() for x in res[name]["losses"]],
                                      [x.item() for x in got["losses"]])   # the same on every rank
    assert_matches(got, ref, name, tol)
    if name == "moe_tp":   # counted once, not tp times
        np.testing.assert_allclose(got["moe_aux_loss"][0].item(), ref["moe_aux_loss"][0].item(),
                                   rtol=1e-5)
    if name == "fsdp_tp":   # a rank holds its fsdp chunk of its model part
        from rt1_tpu_torch.parallel.partition import Partition
        from rt1_tpu_torch.trainer.state import FlatLayout, FlatShard

        part = Partition.from_manifest(results[0][name]["partition"]).part(0)[1]
        chunk = FlatShard.of(FlatLayout.of_shapes(part).size, 0, 2).chunk
        assert all(res[name]["flat_numel"] == chunk for res in results)
        assert chunk < ref["state"]["flat"].numel() // 2

def test_a_rank_holds_its_heads_and_columns(tp2):
    """tp=2 halves the split leaves: the query's rows (heads), `out`'s
    columns, `ff`'s, the embedding's and the head's rows, the experts."""
    checks, results = tp2
    slices = results[0]["tp"]["partition"]["slices"]
    assert slices["transformer.layer_0.attn.query.weight"] == 0
    assert slices["transformer.layer_0.attn.out.weight"] == 1
    assert "transformer.layer_0.attn.out.bias" not in slices
    assert slices["transformer.layer_0.ff.weight"] == 0
    assert slices["transformer.token_emb.weight"] == 0
    assert slices["transformer.output_tokens.bias"] == 0
    assert "transformer.position_emb.weight" not in slices
    assert not any(n.startswith("image_tokenizer") for n in slices)
    moe = results[0]["moe_tp"]["partition"]["slices"]
    assert moe["transformer.layer_0.moe.wi"] == 0 and "transformer.layer_0.moe.gate.weight" \
        not in moe


def test_tensor_parallel_health_pack_reads_the_world_of_one(tp2):
    checks, results = tp2
    ref = reference(checks["health_tp"])
    for rank, res in enumerate(results):
        got = res["health_tp"]
        assert got["pack_names"] == ref["pack_names"]
        np.testing.assert_allclose(got["packs"][0].numpy(), ref["packs"][0].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=f"health pack rank {rank}")


def test_dp_by_tp_matches_jax_data2_model2_step(jax_tiny_run, tp4):
    jm, variables, _ = jax_tiny_run
    checks, results = tp4
    obs, actions = checks["jax_tp"]["batches"][0]
    tx = optax.sgd(SGD_LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables.get("batch_stats", {}),
                          opt_state=tx.init(variables["params"]), tx=tx)
    mesh = make_mesh(JaxMeshConfig(data=2, model=2), devices=jax.devices()[:4])
    fns = make_train_step_fns(jm, mesh, state, donate=False)
    new_state, metrics = fns.train_step(fns.shard_state(state), fns.shard_batch((obs, actions)),
                                        jax.random.PRNGKey(5))
    got = worker.logical_result(results, "jax_tp")
    np.testing.assert_allclose(got["losses"][0].item(), float(metrics["loss"]), rtol=1e-5)
    want = state_dict_from_flax(jax.device_get(new_state.params))
    before = checks["jax_tp"]["weights"]
    grads = dict(zip(got["names"], _views(got["names"], before, got["grads"][0])))
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose((before[name] - SGD_LR * g).numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def _views(names, shapes_of, flat):
    from rt1_tpu_torch.trainer.state import FlatLayout

    return FlatLayout([shapes_of[n] for n in names]).views(flat)


def test_indivisible_dims_stay_whole_and_compute_whole():
    """JAX's `test_indivisible_dims_fall_back_to_replication`: tp=3 divides
    none of tiny's split dims (2 heads, d_model 16, vocab 32, 4 experts),
    so every leaf stays whole; tp=2 at 3 heads keeps attention whole and
    splits the rest."""
    for overrides, whole_attention, split_any in (
            (["parallel.tp=3"], True, False),
            (["parallel.tp=2", "model.num_heads=3"], True, True)):
        cfg = worker.make_config("tiny", overrides)
        plan = ShardingPlan.from_config(cfg, n_devices=cfg.parallel.tp)
        grid = RankGrid(plan.mesh, rank=1, world=cfg.parallel.tp)
        policy = build_policy(cfg)
        shapes = {n: tuple(p.shape) for n, p in policy.named_parameters()}
        partition = partition_policy(policy, grid, plan)
        assert bool(partition.slices) == split_any
        if whole_attention:
            assert not any(".attn." in n for n in partition.slices)
        for name, p in policy.named_parameters():
            assert tuple(p.shape) == partition.local_shape(name, shapes[name])
