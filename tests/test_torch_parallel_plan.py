"""The port's rank grid, sharding plan and rendezvous options against JAX's
(`rt1_tpu/parallel/{mesh,plan,sharding,distributed}.py`), in one process.

Held: `MeshConfig.resolve` and its errors; the grid's rank layout against
the device layout of JAX's `make_mesh` on the forced 8-device CPU mesh;
`auto_mesh_shape` on every `AUTO_MESH_SHAPES` row and on unlisted counts,
with and without a per-host device count; `ShardingPlan.from_config` on
the explicit, auto and `collapse_data` paths; `spec_for_shape`;
`coverage` of the port's flagship, `tiny`, MoE and LAVA parameters against
JAX's on the same configs (empty for the shipped RT-1 configs), the
warning and strict mode's `PlanCoverageError`; `DistributedOptions`'
validation (JAX's missing-field message) and its environment precedence;
`parallel.tp` and `parallel.pp` through `--set` and `from_config` as JAX
resolves them (`auto` on 8 ranks is JAX's (2, 2, 2) row); and the checks
that refuse a CUDA world the host cannot hold before any rendezvous.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.parallel import distributed as jax_distributed
from rt1_tpu.parallel import mesh as jax_mesh
from rt1_tpu.parallel import plan as jax_plan
from rt1_tpu.parallel import sharding as jax_sharding
from rt1_tpu.train.configs import language_table as jax_language_table
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu_torch.configs import apply_override, get_config
from rt1_tpu_torch.eval.restore import build_policy, serving_plan
from rt1_tpu_torch.parallel import distributed
from rt1_tpu_torch.parallel.mesh import AXES, MeshConfig, RankGrid, coords_of, lines, rank_of
from rt1_tpu_torch.parallel.plan import (AUTO_MESH_SHAPES, PlanCoverageError, ShardingPlan,
                                         auto_mesh_shape)
from rt1_tpu_torch.parallel.sharding import spec_for_shape

torch.set_num_threads(2)

SHAPES = [dict(), dict(fsdp=2), dict(data=2, fsdp=2), dict(data=2, seq=2), dict(fsdp=2, seq=2),
          dict(data=2, fsdp=2, seq=2), dict(fsdp=4, seq=2), dict(seq=8), dict(data=4),
          dict(model=2), dict(stage=2), dict(data=2, fsdp=2, model=2), dict(stage=2, model=2)]


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("kw", SHAPES + [dict(fsdp=3), dict(data=3, fsdp=2)])
def test_mesh_resolve_matches_jax(n, kw):
    def resolved(cls):
        try:
            r = cls(**kw).resolve(n)
            return ("ok", tuple(getattr(r, a) for a in AXES))
        except ValueError as exc:
            return ("error", str(exc))

    assert resolved(MeshConfig) == resolved(jax_mesh.MeshConfig)


@pytest.mark.parametrize("kw", [dict(), dict(fsdp=2), dict(fsdp=2, seq=2),
                                dict(data=2, fsdp=2, seq=2), dict(fsdp=4, seq=2), dict(seq=8),
                                dict(seq=2), dict(data=2, fsdp=2, model=2),
                                dict(data=2, stage=2, model=2), dict(stage=4, model=2)])
def test_rank_grid_lays_ranks_out_as_jax_lays_devices(kw):
    cfg = MeshConfig(**kw).resolve(8)
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(**kw))
    ids = [d.id for d in jax.devices()]
    devices = jmesh.devices
    for index in np.ndindex(devices.shape):
        rank = ids.index(devices[index].id)
        assert rank_of(dict(zip(AXES, index)), cfg) == rank
        assert coords_of(rank, cfg) == dict(zip(AXES, index))
    batch_lines = lines(cfg, ("data", "fsdp"))
    assert sorted(r for line in batch_lines for r in line) == list(range(8))
    for line in batch_lines:   # a line shares every coordinate but data and fsdp
        assert len({(coords_of(r, cfg)["seq"], coords_of(r, cfg)["stage"]) for r in line}) == 1


def test_the_world_of_one_has_no_groups_and_one_block():
    grid = RankGrid(MeshConfig())
    assert not grid.distributed and grid.world == 1 and grid.batch_ways == 1
    assert grid.group("data", "fsdp") is None and grid.batch_index == 0


def test_auto_mesh_shapes_match_jax_on_every_row():
    assert AUTO_MESH_SHAPES == jax_plan.AUTO_MESH_SHAPES
    for n in sorted(AUTO_MESH_SHAPES) + [3, 6, 12, 96, 128]:
        for local in (None, 1, 2, 4, 8, 16, 64):
            assert auto_mesh_shape(n, local) == jax_plan.auto_mesh_shape(n, local), (n, local)


def _shape(mesh):
    return {a: int(mesh.shape[a]) for a in AXES}


@pytest.mark.parametrize("block,n", [
    ({}, 8), ({"dp": 2, "fsdp": 2, "sp": 2}, 8), ({"fsdp": 4}, 8), ({"dp": 4, "sp": 2}, 8),
    ({"sp": 8}, 8), ({"auto": True}, 4), ({"auto": True}, 2), ({"auto": True, "sp": 2}, 8),
    ({"strict": True, "fsdp": 2}, 8), ({"dp": 2}, 2), ({"tp": 2}, 2), ({"pp": 2}, 2),
    ({"dp": 2, "tp": 2}, 4), ({"fsdp": 2, "pp": 2}, 4), ({"tp": 2, "pp": 2, "dp": 2}, 8),
    ({"auto": True}, 8), ({"auto": True, "pp": 2}, 8), ({"sp": 2, "tp": 2}, 4)])
def test_from_config_matches_jax(block, n):
    config = {"parallel": block}
    port = ShardingPlan.from_config(config, n_devices=n)
    ref = jax_plan.ShardingPlan.from_config(config, devices=jax.devices()[:n])
    assert port.mesh.shape == _shape(ref.mesh)
    assert port.strict == ref.strict
    assert port.data_parallel_size == ref.data_parallel_size
    assert port.batch_axes == ref.batch_axes


@pytest.mark.parametrize("block,devices", [({}, 1), ({"fsdp": 2, "dp": 4}, 4), ({"sp": 2}, 2),
                                           ({"fsdp": 4}, 2), ({"tp": 2}, 1), ({"tp": 2}, 2),
                                           ({"pp": 2, "tp": 2}, 4)])
def test_collapse_data_matches_jax(block, devices):
    config = {"parallel": block}

    def resolve(fn):
        try:
            return ("ok", fn())
        except ValueError as exc:
            return ("error", str(exc))

    port = resolve(lambda: ShardingPlan.from_config(config, n_devices=devices,
                                                    collapse_data=True).mesh.shape)
    ref = resolve(lambda: _shape(jax_plan.ShardingPlan.from_config(
        config, devices=jax.devices()[:devices], collapse_data=True).mesh))
    assert port == ref


@pytest.mark.parametrize("n,local", [(8, None), (8, 4), (16, 8)])
def test_auto_that_reaches_tensor_parallelism_resolves_as_jax(n, local):
    """8 ranks under `auto` are JAX's (2, 2, 2): tp 2, now run."""
    if n == 8 and local is None:
        assert auto_mesh_shape(8) == (2, 2, 2)
    config = {"parallel": {"auto": True}}
    plan = ShardingPlan.from_config(config, n_devices=n, local_device_count=local)
    dp, fsdp, tp = auto_mesh_shape(n, local)
    assert (plan.mesh.data, plan.mesh.fsdp, plan.mesh.model) == (dp, fsdp, tp)
    assert tp > 1
    if local is None:
        ref = jax_plan.ShardingPlan.from_config(config, devices=jax.devices()[:n])
        assert plan.mesh.shape == _shape(ref.mesh)


def test_serving_plan_warns_and_restores_plainly_where_the_host_is_too_small():
    cfg = get_config("tiny")
    assert serving_plan(cfg).mesh.shape["data"] == 1
    apply_override(cfg, "parallel.fsdp=2")
    with pytest.raises(ValueError, match="fsdp\\*tp\\*pp\\*sp=2 devices"):
        serving_plan(cfg, n_devices=1)


@pytest.mark.parametrize("spec,shape", [
    (("fsdp", "model"), (6, 8)), (("fsdp", "model"), (8, 6)), ((None, None, None, "fsdp"),
                                                               (3, 3, 8, 6)),
    (("model", "fsdp", None), (4, 8, 3)), ((("fsdp", "model"),), (12,)), ((), (5,))])
def test_spec_for_shape_matches_jax(spec, shape):
    from jax.sharding import PartitionSpec as P

    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(data=2, fsdp=2, model=2))
    ref = jax_sharding.spec_for_shape(P(*spec), shape, mesh)
    got = spec_for_shape(spec, shape, {"data": 2, "fsdp": 2, "model": 2})
    assert tuple(got) == tuple(ref)


def _jax_params(model_config):
    from rt1_tpu.specs import language_table_action_space, sample_space
    from rt1_tpu.train.train import build_model

    model = build_model(model_config)
    rng = jax.random.PRNGKey(0)
    t = model_config.time_sequence_length
    obs = {"image": jnp.zeros((1, t, 64, 64, 3), jnp.float32),
           "natural_language_embedding": jnp.zeros((1, t, 512), jnp.float32)}
    actions = sample_space(language_table_action_space(), jax.random.fold_in(rng, 1), (1, t))
    variables = jax.eval_shape(
        lambda r: model.init({"params": r, "crop": r}, obs, actions, train=False), rng)
    return variables["params"]


@pytest.mark.parametrize("name,overrides", [
    ("tiny", {}), ("tiny", {"ffn_impl": "moe"}), ("language_table", {}),
    ("language_table", {"ffn_impl": "moe"}), ("tiny", {"image_tokenizer": "efficientnet_small"})])
def test_coverage_of_the_port_equals_jax(name, overrides):
    jcfg = (jax_tiny if name == "tiny" else jax_language_table).get_config()
    cfg = get_config(name)
    for key, value in overrides.items():
        setattr(jcfg.model, key, value)
        apply_override(cfg, f"model.{key}={value}")
    ref = jax_plan.ShardingPlan(mesh=jax_mesh.make_mesh(jax_mesh.MeshConfig())).coverage(
        _jax_params(jcfg.model))
    got = ShardingPlan(mesh=MeshConfig().resolve(1)).coverage(build_policy(cfg))
    assert sorted(got) == sorted(ref) == []


def test_lava_coverage_equals_jax():
    from test_torch_lava import _pair

    _, pm, variables, _ = _pair(1)
    ref = jax_plan.ShardingPlan(mesh=jax_mesh.make_mesh(jax_mesh.MeshConfig())).coverage(
        variables["params"])
    got = ShardingPlan(mesh=MeshConfig().resolve(1)).coverage(pm)
    assert sorted(got) == sorted(ref) and got   # the rules describe RT-1's paths only


def test_coverage_warns_and_strict_raises(caplog):
    tree = {"mystery_module": {"w": torch.zeros(4, 4)}, "small": torch.zeros(4)}
    plan = ShardingPlan(mesh=MeshConfig().resolve(1))
    assert plan.coverage(tree) == ["mystery_module/w"]
    with caplog.at_level(logging.WARNING, logger="rt1_tpu_torch.parallel.plan"):
        plan.check_coverage(tree)
    assert any("mystery_module/w" in r.message for r in caplog.records)
    strict = ShardingPlan(mesh=MeshConfig().resolve(1), strict=True)
    with pytest.raises(PlanCoverageError, match="mystery_module/w"):
        strict.check_coverage(tree)
    assert strict.check_coverage(build_policy(get_config("tiny"))) == []


@pytest.mark.parametrize("key,n", [("parallel.tp=2", 2), ("parallel.pp=2", 2),
                                   ("parallel.tp=2", 4), ("parallel.pp=2", 8)])
def test_tp_and_pp_parse_and_resolve_as_jax(key, n):
    """`--set parallel.tp=2` / `parallel.pp=2` are kept and resolve as
    JAX's `ShardingPlan.from_config` on the same device count."""
    cfg = get_config("tiny")
    apply_override(cfg, key)
    axis, value = key.split(".")[1].split("=")
    assert getattr(cfg.parallel, axis) == int(value)
    port = ShardingPlan.from_config(cfg, n_devices=n)
    ref = jax_plan.ShardingPlan.from_config({"parallel": {axis: int(value)}},
                                            devices=jax.devices()[:n])
    assert port.mesh.shape == _shape(ref.mesh)
    assert port.data_parallel_size == ref.data_parallel_size


def test_parallel_keys_parse():
    cfg = get_config("tiny")
    for key in ["parallel.dp=2", "parallel.fsdp=2", "parallel.sp=2", "parallel.auto=true",
                "parallel.strict=true", "parallel.distributed.enabled=true",
                "parallel.distributed.coordinator_address=localhost:1234",
                "parallel.distributed.process_id=1", "parallel.distributed.num_processes=8",
                "model.attention_impl=ring", "model.pipeline_microbatches=8", "parallel.tp=2",
                "parallel.pp=4"]:
        apply_override(cfg, key)
    par = cfg.parallel
    assert (par.dp, par.fsdp, par.sp, par.auto, par.strict) == (2, 2, 2, True, True)
    assert (par.tp, par.pp) == (2, 4)
    d = par.distributed
    assert (d.enabled, d.coordinator_address, d.process_id, d.num_processes) == \
        (True, "localhost:1234", 1, 8)
    with pytest.raises(ValueError, match="parallel.sp=0"):
        apply_override(cfg, "parallel.sp=0")


ENV = ("RT1_COORDINATOR", "RT1_PROCESS_ID", "RT1_NUM_PROCESSES", "MASTER_ADDR", "MASTER_PORT",
       "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "JAX_COORDINATOR_ADDRESS",
       "JAX_PROCESS_ID", "JAX_NUM_PROCESSES")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _block(**kw):
    return {"parallel": {"distributed": dict({"enabled": True}, **kw)}}


@pytest.mark.parametrize("kw", [dict(coordinator_address="h:1"), dict(process_id=0),
                                dict(coordinator_address="h:1", num_processes=2),
                                dict(process_id=0, num_processes=2)])
def test_partial_rendezvous_names_the_missing_fields_as_jax(clean_env, kw):
    with pytest.raises(ValueError) as port:
        distributed.DistributedOptions.from_config(_block(**kw)).validate()
    with pytest.raises(ValueError) as ref:
        jax_distributed.DistributedOptions.from_config(_block(**kw)).validate()
    assert str(port.value).split(" — ")[0] == str(ref.value).split(" — ")[0]


@pytest.mark.parametrize("kw,message", [
    (dict(coordinator_address="h:1", process_id=2, num_processes=2), "out of range"),
    (dict(coordinator_address="h:1", process_id=0, num_processes=0), "must be >= 1")])
def test_bad_rendezvous_values_raise_as_jax(clean_env, kw, message):
    for cls in (distributed.DistributedOptions, jax_distributed.DistributedOptions):
        with pytest.raises(ValueError, match=message):
            cls.from_config(_block(**kw)).validate()


def test_environment_precedence(clean_env):
    opts = distributed.DistributedOptions.from_config
    clean_env.setenv("RT1_COORDINATOR", "a:1")
    clean_env.setenv("RT1_PROCESS_ID", "1")
    clean_env.setenv("RT1_NUM_PROCESSES", "4")
    port = opts(_block())
    ref = jax_distributed.DistributedOptions.from_config(_block())
    assert (port.coordinator_address, port.process_id, port.num_processes) == \
        (ref.coordinator_address, ref.process_id, ref.num_processes) == ("a:1", 1, 4)
    assert port.init_method == "tcp://a:1"
    # The launcher's names come after RT1_*; the config block before both.
    clean_env.setenv("MASTER_ADDR", "b")
    clean_env.setenv("MASTER_PORT", "2")
    clean_env.setenv("RANK", "3")
    clean_env.setenv("WORLD_SIZE", "8")
    assert opts(_block()).coordinator_address == "a:1" and opts(_block()).process_id == 1
    assert opts(_block(process_id=2)).process_id == 2
    for name in ("RT1_COORDINATOR", "RT1_PROCESS_ID", "RT1_NUM_PROCESSES"):
        clean_env.delenv(name)
    launched = opts(_block())
    assert (launched.coordinator_address, launched.process_id, launched.num_processes) == \
        ("b:2", 3, 8)
    assert launched.init_method == "env://"   # the launcher's agent serves the store
    launched.validate()


def test_enabled_with_nothing_set_needs_the_launcher(clean_env):
    with pytest.raises(ValueError, match="torch.distributed.run"):
        distributed.DistributedOptions.from_config(_block()).validate()
    assert not distributed.DistributedOptions.from_config({"parallel": {}}).enabled
    assert distributed.initialize_from_config({"parallel": {}}) is False


def test_cuda_worlds_the_host_cannot_hold_raise_before_the_rendezvous(clean_env):
    import torch.distributed as dist

    opts = distributed.DistributedOptions(enabled=True, coordinator_address="localhost:1",
                                          process_id=0, num_processes=2)
    assert distributed.check_backend("cpu", opts) == "gloo"
    with pytest.raises((RuntimeError, ValueError)):
        distributed.check_backend("cuda", opts)
    clean_env.setattr(dist, "is_nccl_available", lambda: True)
    clean_env.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks on this host .* 1 GPU"):
        distributed.check_backend("cuda", opts)
    clean_env.setenv("LOCAL_WORLD_SIZE", "1")
    clean_env.setenv("LOCAL_RANK", "0")
    assert distributed.check_backend("cuda", opts) == "nccl"
    clean_env.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        distributed.check_backend("cuda", opts)
    with pytest.raises((RuntimeError, ValueError)):
        distributed.initialize_from_config(_block(coordinator_address="localhost:1",
                                                  process_id=0, num_processes=2),
                                           device="cuda")
    assert not dist.is_initialized()


def test_batch_plan_checks_at_the_config_seam():
    from rt1_tpu_torch.train.train import check_batch_plan

    cfg = get_config("tiny")
    apply_override(cfg, "parallel.sp=2")
    plan = ShardingPlan.from_config(cfg, n_devices=2)
    with pytest.raises(ValueError, match="attention_impl='ring'"):
        check_batch_plan(cfg, plan)
    apply_override(cfg, "model.attention_impl=ring")
    check_batch_plan(cfg, plan)
    apply_override(cfg, "accum_steps=3")
    with pytest.raises(ValueError, match="accum_steps=3"):
        check_batch_plan(cfg, plan)
