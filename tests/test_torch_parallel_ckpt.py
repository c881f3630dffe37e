"""Checkpoint plan migration on gloo groups of the CPU.

A group of 2 ranks initialises the `tiny` config with the
efficientnet_small tokenizer (BatchNorm statistics in the replicated part)
under fsdp=2, takes one step (the moments are not zero) and saves it as
step 1, then leaves a torn step 2 (a shard file, no manifest). A group of
4 restores the newest step under dp=4 and saves it as step 3, then
restores that under fsdp=4 and saves it as step 5. The world of one
restores step 5. Each restore hands back the saved logical state byte for
byte (`parallel.reshard.gathered_equal`: masters, both moments, the
statistics, the counters); rank 0 alone writes the provenance (the other
ranks' managers raise if they try); the serving engine built from any of
the steps gives the same logits, bit for bit, as one built from the
unsharded state, and a config asking for more devices than the host has
is restored with plain placement and a warning. The same for a tp=2 and a
pp=2 checkpoint, each restored under the other plans in turn (below,
`parts`).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from rt1_tpu_torch.eval.restore import build_serve_engine
from rt1_tpu_torch.parallel.reshard import gathered_equal
from rt1_tpu_torch.train.train import build_model
from rt1_tpu_torch.trainer.checkpoints import CheckpointManager, all_steps
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import create_train_state
import torch_parallel_worker as worker

torch.set_num_threads(2)

SMALL = ["model.image_tokenizer=efficientnet_small", "model.dropout_rate=0",
         "regularization.crop_ratio=0", "regularization.drop_connect_rate=0"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    cfg = worker.make_config("tiny", SMALL)
    weights = {k: v.clone() for k, v in build_model(cfg, "cpu").state_dict().items()}
    directory = str(tmp / "run" / "checkpoints")
    base = dict(config="tiny", weights=weights, directory=directory)
    saved = worker.spawn(2, "ckpt_save", dict(
        base, overrides=SMALL + ["parallel.fsdp=2"], save_step=1, torn_step=2,
        batches=[worker.global_batch(5, 4, 3, 32, 56)]), tmp)
    chain = worker.spawn(4, "ckpt_chain", dict(base, chain=[
        {"overrides": SMALL + ["parallel.dp=4"], "save_step": 3},
        {"overrides": SMALL + ["parallel.fsdp=4"], "save_step": 5}]), tmp)
    return dict(cfg=cfg, weights=weights, directory=directory, workdir=str(tmp / "run"),
                saved=saved, chain=chain, tmp=tmp)


def world_one_state(run, step=None):
    policy = build_model(run["cfg"], "cpu")
    state = create_train_state(policy, Adam(**worker.OPT))
    manager = CheckpointManager(run["directory"])
    if step is None:
        state, restored = manager.restore_or_initialize(state)
    else:
        restored = manager.restore(state, step)
    return state, restored


def test_fsdp2_checkpoint_restores_byte_identical_under_dp4_fsdp4_and_world_one(run):
    saved = run["saved"][0]["state"]
    assert saved["step"] == 1 and saved["count"] == 1 and saved["mu"].abs().sum() > 0
    assert gathered_equal(saved, run["saved"][1]["state"])
    for rank, links in enumerate(run["chain"]):
        dp4, fsdp4 = links
        assert dp4["step"] == 1 and fsdp4["step"] == 3, rank   # torn step 2 skipped
        assert gathered_equal(dp4["state"], saved), f"dp=4 rank {rank}"
        assert gathered_equal(fsdp4["state"], saved), f"fsdp=4 rank {rank}"
        # dp=4 holds the whole vector; fsdp=4 a quarter of it
        assert dp4["chunk"].numel() == saved["flat"].numel()
        assert fsdp4["chunk"].numel() * 4 >= saved["flat"].numel() > fsdp4["chunk"].numel() * 3
    state, restored = world_one_state(run)
    assert restored == 5
    assert gathered_equal(worker.logical_state(state), saved)


def test_a_torn_step_is_not_a_step_and_manifests_record_the_plan(run):
    assert all_steps(run["directory"]) == [1, 3, 5]
    assert os.path.isdir(os.path.join(run["directory"], "2"))
    manifests = {}
    for step in (1, 3, 5):
        with open(os.path.join(run["directory"], str(step), "manifest.json")) as f:
            manifests[step] = json.load(f)
    assert [manifests[s]["world"] for s in (1, 3, 5)] == [2, 4, 4]
    assert [manifests[s]["fsdp"] for s in (1, 3, 5)] == [2, 1, 4]
    assert manifests[3]["mesh"]["data"] == 4 and manifests[5]["mesh"]["fsdp"] == 4
    assert len(manifests[5]["shards"]) == 4
    assert manifests[1]["process_count"] == 2 and manifests[1]["local_device_count"] == 1
    with open(os.path.join(run["directory"], "saved_under.json")) as f:
        provenance = json.load(f)
    assert provenance["step"] == 5 and provenance["process_count"] == 4


def test_every_step_serves_the_logits_of_the_unsharded_state(run, caplog):
    state, _ = world_one_state(run, step=1)
    plain = run["tmp"] / "plain"
    CheckpointManager(str(plain / "checkpoints")).save(1, state)   # the one-file format
    rng = np.random.default_rng(9)
    obs = {"image": torch.from_numpy(rng.uniform(0, 1, (2, 32, 56, 3)).astype(np.float32)),
           "natural_language_embedding": torch.from_numpy(
               rng.standard_normal((2, 512)).astype(np.float32))}

    def logits(cfg, workdir, step):
        engine, restored = build_serve_engine(cfg, workdir=workdir, device="cpu", step=step)
        assert restored == step
        out, _ = engine.policy.infer_step(obs, engine.policy.initial_state(2))
        return out["action_logits"]

    reference = logits(run["cfg"], str(plain), 1)
    for step in (1, 3, 5):
        assert torch.equal(logits(run["cfg"], run["workdir"], step), reference), step
    wide = worker.make_config("tiny", SMALL + ["parallel.fsdp=4"])
    with caplog.at_level(logging.WARNING, logger="rt1_tpu_torch.eval.restore"):
        assert torch.equal(logits(wide, run["workdir"], 5), reference)
    assert any("plain placement" in r.message for r in caplog.records)


def test_flat_chunks_pad_and_reassemble_for_any_count():
    """A layout whose length the fsdp count does not divide: the chunks
    are zero-padded past it and reassemble to the logical vector, NaN and
    -0.0 included."""
    from rt1_tpu_torch.parallel.reshard import assemble_flat
    from rt1_tpu_torch.trainer.state import FlatShard

    logical = torch.arange(130, dtype=torch.float32)
    logical[5], logical[7] = float("nan"), -0.0
    for count in (1, 2, 3, 4, 7):
        shards = [FlatShard.of(130, i, count) for i in range(count)]
        assert all(s.size % count == 0 and s.size >= 130 for s in shards)
        chunks = [s.take(logical) for s in shards]
        assert all(c.numel() == shards[0].chunk for c in chunks)
        assert gathered_equal(assemble_flat(chunks, 130), logical)
        assert not torch.cat(chunks)[130:].any()   # the padding is zeros


# Tensor and pipeline parallelism: one group of 2 ranks writes a tp=2 and
# a pp=2 checkpoint (one step each: the moments are not zero), then
# restores each under the other plans in turn (the tp=2 one under fsdp=2,
# then pp=2; the pp=2 one under tp=2, then fsdp=2), saving each restored
# state as the next step. The world of one restores every step; each hands
# back the saved logical state byte for byte, and the serving engine built
# from each serves the unsharded state's logits bit for bit.
PARTS = {"tp": SMALL + ["parallel.tp=2"],
         "pp": SMALL + ["parallel.pp=2", "model.pipeline_microbatches=2"],
         "fsdp": SMALL + ["parallel.fsdp=2"]}


@pytest.fixture(scope="module")
def parts(run, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parts")
    base = dict(config="tiny", weights=run["weights"])
    dirs = {name: str(tmp / name / "checkpoints") for name in ("tp", "pp")}
    batch = [worker.global_batch(6, 4, 3, 32, 56)]
    chains = {"tp": ["fsdp", "pp"], "pp": ["tp", "fsdp"]}
    jobs = [dict(base, kind="save", directory=dirs[name], overrides=PARTS[name], save_step=1,
                 batches=batch) for name in ("tp", "pp")]
    jobs += [dict(base, kind="chain", directory=dirs[name], chain=[
        {"overrides": PARTS[plan], "save_step": 3 + 2 * i} for i, plan in enumerate(chains[name])])
        for name in ("tp", "pp")]
    results = worker.spawn(2, "ckpt_jobs", {"jobs": jobs}, tmp)
    return dict(dirs=dirs, chains=chains, tmp=tmp,
                saved={name: worker.logical_state_of([r[i] for r in results])
                       for i, name in enumerate(("tp", "pp"))},
                links={name: [worker.logical_state_of([r[2 + i][k] for r in results])
                              for k in range(2)] for i, name in enumerate(("tp", "pp"))},
                steps={name: [[r[2 + i][k]["step"] for r in results] for k in range(2)]
                       for i, name in enumerate(("tp", "pp"))})


def _world_one(run, directory, step):
    state = create_train_state(build_model(run["cfg"], "cpu"), Adam(**worker.OPT))
    assert CheckpointManager(directory).restore(state, step) == step
    return worker.logical_state(state)


@pytest.mark.parametrize("name", ["tp", "pp"])
def test_tp_and_pp_checkpoints_restore_under_every_plan_and_the_world_of_one(run, parts, name):
    saved = parts["saved"][name]
    assert saved["step"] == 1 and saved["mu"].abs().sum() > 0
    for link, (restored, steps) in enumerate(zip(parts["links"][name], parts["steps"][name])):
        assert steps == [1 + 2 * link] * 2   # each link restores the newest step
        assert gathered_equal(restored, saved), (name, parts["chains"][name][link])
    for step in (1, 3, 5):
        assert gathered_equal(_world_one(run, parts["dirs"][name], step), saved), (name, step)
    with open(os.path.join(parts["dirs"][name], "1", "manifest.json")) as f:
        manifest = json.load(f)
    ways = {"tp": (1, 2), "pp": (2, 1)}[name]
    assert (manifest["partition"]["stage_ways"], manifest["partition"]["model_ways"]) == ways
    assert len(manifest["parts"]) == 2 and manifest["names"] == list(
        dict(build_model(run["cfg"], "cpu").named_parameters()))
    if name == "pp":
        assert {p["stage"] for p in manifest["parts"]} == {0, 1}
        assert set(manifest["partition"]["stage_of"].values()) == {0, 1}
    else:
        assert manifest["partition"]["slices"]["transformer.layer_0.attn.query.weight"] == 0


@pytest.mark.parametrize("name", ["tp", "pp"])
def test_tp_and_pp_checkpoints_serve_the_unsharded_state(run, parts, name, caplog):
    state = create_train_state(build_model(run["cfg"], "cpu"), Adam(**worker.OPT))
    CheckpointManager(parts["dirs"][name]).restore(state, 1)
    plain = parts["tmp"] / f"plain_{name}"
    CheckpointManager(str(plain / "checkpoints")).save(1, state)
    rng = np.random.default_rng(19)
    obs = {"image": torch.from_numpy(rng.uniform(0, 1, (2, 32, 56, 3)).astype(np.float32)),
           "natural_language_embedding": torch.from_numpy(
               rng.standard_normal((2, 512)).astype(np.float32))}

    def logits(cfg, workdir, step):
        engine, restored = build_serve_engine(cfg, workdir=workdir, device="cpu", step=step)
        assert restored == step
        return engine.policy.infer_step(obs, engine.policy.initial_state(2))[0]["action_logits"]

    reference = logits(run["cfg"], str(plain), 1)
    workdir = os.path.dirname(parts["dirs"][name])
    wide = worker.make_config("tiny", PARTS[name])   # a plan one host cannot hold
    with caplog.at_level(logging.WARNING, logger="rt1_tpu_torch.eval.restore"):
        for step in (1, 3, 5):
            assert torch.equal(logits(wide, workdir, step), reference), step
    assert any("plain placement" in r.message for r in caplog.records)
