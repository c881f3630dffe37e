"""`examples/torch/parallelism_example.py` against JAX's
`examples/parallelism_example.py`: one Adam step (lr 1e-3) of the tiny
RT-1 under dp, tp, sp, pp and ep on 8 ranks.

The JAX side is JAX's example itself: its `tiny()` initialised at
PRNGKey(0) by `create_train_state`, its `batch(PRNGKey(0))`, and its five
modes (read from its `main()`), each one step of `make_train_step_fns` at
PRNGKey(1) on its mesh over the 8 CPU devices `tests/conftest.py` gives
JAX. pp is held to JAX's dp step: JAX's own pipeline fails on jax 0.9.0
(`rt1_tpu/parallel/pipeline.py:185` passes `check_rep=False`, which
`shard_map` no longer takes). The port runs its example's `run` on the CPU
(8 gloo ranks) on JAX's variables, carried across by
`convert.state_dict_from_flax`, and JAX's batch.

Both sides run at `crop_ratio=0`: the crop draws its offset from each
framework's own random numbers (a PRNGKey, a torch Generator), which no
seed makes equal. `tiny()` has no dropout.

tp and ep put 2 heads on 4 `model` ranks. Both packages split the FFN's,
the token embedding's and the head's columns, and under ep the 4 experts,
one a rank (JAX by its plan's specs through `spec_for_shape`, the port by
`partition_policy`). Attention differs by design: JAX's query, key, value
and out kernels are 2-D (16 = 2 heads x 8 columns), which 4 divides, so
its plan lays them out over `model` at a quarter head a rank and GSPMD
gathers what each use needs; the port's tensor-parallel attention splits
whole heads, so 2 heads on 4 ranks stay whole on every rank. The step's
numbers are the same either way.

Tolerances, float32: each mode's loss and gradient norm within rtol 1e-5
of JAX's (found within 2.1e-7), and within rtol 1e-6 of the port's world
of one (`TrainStepFns` in one process on the whole batch; found within
2.1e-7), the same on every rank. The parameters after the step are not
compared: Adam's first step turns rounding into any update in [-lr, lr]
(`tests/test_torch_parallel_tp.py`).
"""

import ast
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from rt1_tpu.parallel import MeshConfig as JaxMeshConfig
from rt1_tpu.parallel import make_mesh
from rt1_tpu.parallel.plan import ShardingPlan as JaxShardingPlan
from rt1_tpu.parallel.sharding import _path_str
from rt1_tpu.trainer import create_train_state, make_optimizer, make_train_step_fns
from rt1_tpu_torch.convert import flax_paths, state_dict_from_flax
from rt1_tpu_torch.parallel import MeshConfig, RankGrid, ShardingPlan, partition_policy
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import create_train_state as port_train_state
from rt1_tpu_torch.trainer.train import TrainStepFns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLE = os.path.join(REPO, "examples", "parallelism_example.py")
PORT_EXAMPLES = os.path.join(REPO, "examples", "torch")

# The spawned ranks import the port's example by name from the path they
# inherit; JAX's, of the same file name, is loaded under another name.
sys.path.insert(0, PORT_EXAMPLES)
import parallelism_example as port_example  # noqa: E402

_spec = importlib.util.spec_from_file_location("jax_parallelism_example", JAX_EXAMPLE)
jax_example = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_example)

NO_CROP = {"crop_ratio": 0.0}
JAX_TOL = 1e-5
WORLD_ONE_TOL = 1e-6
MODES = ["dp", "tp", "sp", "pp", "ep"]


def jax_modes():
    """(label, MeshConfig, model kwargs) of each mode, as JAX's `main()`
    lists them."""
    with open(JAX_EXAMPLE) as f:
        tree = ast.parse(f.read())
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    listed = next(node.value for node in ast.walk(main) if isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", None) == "modes")
    return eval(compile(ast.Expression(listed), JAX_EXAMPLE, "eval"),
                {"MeshConfig": JaxMeshConfig, "dict": dict})


@pytest.fixture(scope="module")
def jax_run():
    """JAX's step of each mode (pp: dp's), its mesh shapes, the dense and
    MoE variables (and as the port's state_dicts), and the batch."""
    rng = jax.random.PRNGKey(0)
    obs, actions = jax_example.batch(rng)
    tx = make_optimizer(learning_rate=1e-3)
    steps, meshes, params = {}, {}, {}
    for label, mesh_cfg, model_kw in jax_modes():
        name = label[:2]
        mesh = make_mesh(mesh_cfg)
        meshes[name] = dict(mesh.shape)
        if mesh.shape["stage"] > 1:
            steps[name] = steps["dp"]
            continue
        kw = dict(model_kw, **NO_CROP)
        if mesh.shape["seq"] > 1:
            kw.update(attention_impl="ring", mesh=mesh)
        model = jax_example.tiny(**kw)
        state = create_train_state(model, rng, (obs, actions), tx)
        params.setdefault(kw.get("ffn_impl", "dense"), jax.device_get(state.params))
        fns = make_train_step_fns(model, mesh, state, donate=False)
        _, metrics = fns.train_step(fns.shard_state(state), fns.shard_batch((obs, actions)),
                                    jax.random.PRNGKey(1))
        steps[name] = (float(metrics["loss"]), float(metrics["grad_norm"]))
    rows = tuple({k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
                 for tree in (obs, actions))
    return {"labels": [label for label, _, _ in jax_modes()], "steps": steps,
            "meshes": meshes, "params": params, "rows": rows,
            "weights": {ffn: state_dict_from_flax(tree) for ffn, tree in params.items()}}


@pytest.fixture(scope="module")
def port_run(jax_run):
    records = port_example.run("cpu", jax_run["weights"], jax_run["rows"], tiny_kw=NO_CROP)
    return {r["label"][:2]: r for r in records}, [r["label"] for r in records]


@pytest.fixture(scope="module")
def world_one(jax_run):
    """The port's one-process step on the whole batch, dense and MoE."""
    out = {}
    for ffn, kw in (("dense", {}), ("moe", dict(ffn_impl="moe", num_experts=4))):
        policy = port_example.tiny(**kw, **NO_CROP)
        policy.load_state_dict(jax_run["weights"][ffn])
        tx = Adam(learning_rate=1e-3)
        metrics = TrainStepFns(tx, seed=1).train_step(port_train_state(policy, tx),
                                                     jax_run["rows"], 0)
        out[ffn] = (float(metrics["loss"]), float(metrics["grad_norm"]))
    return out


def test_the_modes_are_jax_examples_in_its_order_on_the_host(jax_run, port_run):
    records, labels = port_run
    assert labels == jax_run["labels"]
    assert [label[:2] for label in labels] == MODES
    for name, record in records.items():
        assert record["mesh"] == jax_run["meshes"][name], name
        assert record["devices"] == ["cpu"] and record["launches"] == 0, name


@pytest.mark.parametrize("mode", MODES)
def test_each_mode_matches_jax_step_on_the_same_mesh(jax_run, port_run, mode):
    record = port_run[0][mode]
    loss, grad_norm = jax_run["steps"][mode]
    np.testing.assert_allclose(record["loss"], loss, rtol=JAX_TOL)
    np.testing.assert_allclose(record["grad_norm"], grad_norm, rtol=JAX_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_each_mode_matches_the_world_of_one(port_run, world_one, mode):
    record = port_run[0][mode]
    loss, grad_norm = world_one["moe" if mode == "ep" else "dense"]
    assert len(set(record["losses"])) == 1   # every rank reads the global loss
    np.testing.assert_allclose(record["loss"], loss, rtol=WORLD_ONE_TOL)
    np.testing.assert_allclose(record["grad_norm"], grad_norm, rtol=WORLD_ONE_TOL)


def _names_model(spec):
    return any(e == "model" or (isinstance(e, tuple) and "model" in e) for e in spec)


@pytest.mark.parametrize("ffn", ["dense", "moe"])
def test_tp_and_ep_split_the_leaves_jax_shards_over_model(jax_run, ffn):
    mesh = make_mesh(JaxMeshConfig(data=2, model=4))
    shardings = JaxShardingPlan(mesh=mesh).tree_shardings(jax_run["params"][ffn])
    jax_split = {_path_str(path) for path, sharding in
                 jax.tree_util.tree_flatten_with_path(shardings)[0]
                 if _names_model(sharding.spec)}
    policy = port_example.tiny(**({} if ffn == "dense" else dict(ffn_impl="moe", num_experts=4)))
    shapes = {name: tuple(p.shape) for name, p in policy.named_parameters()}
    paths = {name: path.split("/", 1)[1] for name, path in flax_paths(policy).items()}
    grid = RankGrid(MeshConfig(data=2, model=4), rank=1, world=8)
    partition = partition_policy(policy, grid, ShardingPlan(mesh=grid.mesh))
    attention = {path for path in jax_split if "/attn/" in path}
    assert {paths[name] for name in partition.slices} == jax_split - attention
    assert attention == {f"transformer/layer_{i}/attn/{leaf}" for i in range(4)
                         for leaf in ("query/kernel", "query/bias", "key/kernel", "key/bias",
                                      "value/kernel", "value/bias", "out/kernel")}
    split_by = {"dense": "/ff/", "moe": "/moe/w"}[ffn]
    assert sum(split_by in path for path in jax_split) == 4 * 2   # kernel and bias / wi and wo
    assert {"transformer/token_emb/kernel", "transformer/output_tokens/kernel"} <= jax_split
    if ffn == "moe":   # one of the 4 experts a rank
        assert partition.local_shape("transformer.layer_0.moe.wi",
                                     shapes["transformer.layer_0.moe.wi"])[0] == 1
