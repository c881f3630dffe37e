"""The port's learning-proof pieces against the JAX package's, and its CLI.

* `proof_train_config`: every field the JAX config also has, equal, for
  the decaying and the constant schedule and a pretrained encoder; the LR
  boundaries (milestone x steps_per_epoch) equal.
* `criterion_met` and `build_proof_summary`: equal results and dicts for
  the same inputs; `write_proof_json` writes the same bytes.
* `stamp_train_meta` / `check_train_meta`: the same file and the same
  refusals.
* `archive_file`: the same no-clobber names; `copy_proof_videos` stages
  the same files under the same names as JAX's. `read_scalar_curves` reads the trainer's
  `metrics.jsonl`.
* `corpus_entropy`: within 1e-9 of `scripts/policy_diagnostics.py`'s
  function (run from its source, without the script's flags), on a
  synthetic corpus.
* `python -m rt1_tpu_torch.train.learn_proof --config tiny --device cpu`
  in process: collect 3 (2 workers), train 2 steps, DAgger 1 round of 1
  episode + 2 steps, eval 1 episode an arm; `learn_proof.json` carries
  the JAX summary's keys (plus `loss_curves` and `corpus_entropy`), the
  evaluated step is 4 and the corpus counts 4 episodes; each stage resumes
  or refuses as the JAX script's does; without `--device cpu` and no card
  it raises.
"""

import ast
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from rt1_tpu.data.episodes import generate_synthetic_episode, save_episode
from rt1_tpu.eval import proof as jax_proof
from rt1_tpu.train import meta as jax_meta
from rt1_tpu.train.proof_config import proof_train_config as jax_proof_train_config
from rt1_tpu.utils import artifacts as jax_artifacts
from rt1_tpu_torch.eval import proof
from rt1_tpu_torch.eval.diagnostics import corpus_entropy
from rt1_tpu_torch.train import learn_proof, meta
from rt1_tpu_torch.train.proof_config import proof_train_config
from rt1_tpu_torch.utils import archive_file, copy_proof_videos, read_scalar_curves, \
    write_loss_curves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REWARD = "block2block"


def _config_pairs(port, ref, prefix=""):
    """(dotted key, port value, JAX value) for every port field the JAX
    config also has."""
    for field in dataclasses.fields(port):
        value = getattr(port, field.name)
        key = prefix + field.name
        if field.name not in ref:
            continue
        if dataclasses.is_dataclass(value):
            yield from _config_pairs(value, ref[field.name], key + ".")
        else:
            yield key, value, ref[field.name]


@pytest.mark.parametrize("num_steps,constant_lr,extra", [
    (1000, False, {}),
    (1000, True, {"pretrained_encoder": "enc.pt", "seq_len": 1, "focal_gamma": 2.0}),
    (50, False, {"image_tokenizer": "efficientnet_small", "dtype": "float32", "height": 64,
                 "width": 96, "batch": 16, "checkpoint_every": 25, "aux_mse_weight": 0.5}),
])
def test_proof_train_config_matches_jax(num_steps, constant_lr, extra):
    port = proof_train_config("/data", num_steps, constant_lr=constant_lr, **extra)
    ref = jax_proof_train_config("/data", num_steps, constant_lr=constant_lr, **extra)
    pairs = list(_config_pairs(port, ref))
    assert len(pairs) > 40
    for key, got, want in pairs:
        want = tuple(want) if isinstance(want, (list, tuple)) else want
        assert got == want, key
    assert [m * port.steps_per_epoch for m in port.lr_milestones] == \
        [m * ref.steps_per_epoch for m in ref.lr_milestones]
    if constant_lr:
        assert min(port.lr_milestones) * port.steps_per_epoch > num_steps
    elif num_steps == 1000:
        assert [m * port.steps_per_epoch for m in port.lr_milestones] == [500, 750, 900]
    assert port.model.pretrained_encoder == extra.get("pretrained_encoder")


def _results(successes, mean_len=40.0):
    return {"successes": {REWARD: successes}, "mean_episode_length": {REWARD: mean_len}}


SUMMARY_CASES = {
    "manifest": dict(manifest={"embedder": "ngram", "exec_noise_std": 0.005}),
    "clean_manifest": dict(manifest={"embedder": "ngram"}, trained=_results(1),
                           oracle_results=_results(1)),
    "no_manifest": dict(manifest=None, curves={"loss": [], "eval_loss": [(5, 0.2)]}),
    "headline": dict(manifest={}, eval_episodes=50, trained=_results(30),
                     oracle_results=_results(40)),
}


def _summary_kwargs(**overrides):
    kwargs = dict(
        reward=REWARD, block_mode="BLOCK_4", manifest=None, flag_embedder="hash",
        flag_exec_noise_std=0.25, episodes_collected=400,
        split_counts={"train": 390, "val": 5, "test": 5}, num_steps_requested=50_000,
        evaluated_checkpoint_step=65_000, seq_len=1, focal_gamma=0.0, aux_mse_weight=0.0,
        image_tokenizer="efficientnet_b3", resolution=[128, 224], eval_episodes=20,
        eval_seed=10_000, trained=_results(6), random_results=_results(0),
        oracle_results=_results(10), curves={"loss": [(0, 3.2), (100, 0.9)], "eval_loss": []})
    kwargs.update(overrides)
    return kwargs


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
def test_proof_summary_matches_jax(case, tmp_path):
    kwargs = _summary_kwargs(**SUMMARY_CASES[case])
    got, want = proof.build_proof_summary(**kwargs), jax_proof.build_proof_summary(**kwargs)
    assert got == want
    for name, writer, summary in (("port", proof.write_proof_json, got),
                                  ("ref", jax_proof.write_proof_json, want)):
        os.makedirs(tmp_path / name)
        writer(str(tmp_path / name), summary)
    assert (tmp_path / "port" / "learn_proof.json").read_bytes() == \
        (tmp_path / "ref" / "learn_proof.json").read_bytes()


def test_criterion_and_constants_match_jax():
    for trained in range(0, 12):
        for oracle in range(0, 12):
            assert proof.criterion_met(trained, oracle) == jax_proof.criterion_met(trained, oracle)
    assert proof.SUCCESS_CRITERION == jax_proof.SUCCESS_CRITERION
    assert proof.MIN_EPISODES_FOR_SUCCESS_HEADLINE == jax_proof.MIN_EPISODES_FOR_SUCCESS_HEADLINE


def test_train_meta_matches_jax(tmp_path):
    values = {"seq_len": 1, "batch": 16, "image_tokenizer": "efficientnet_b3"}
    meta.stamp_train_meta(str(tmp_path / "port"), values)
    jax_meta.stamp_train_meta(str(tmp_path / "ref"), values)
    assert (tmp_path / "port" / meta.META_NAME).read_bytes() == \
        (tmp_path / "ref" / jax_meta.META_NAME).read_bytes()
    for check in (meta.check_train_meta, jax_meta.check_train_meta):
        check(str(tmp_path / "port"), "eval", {"seq_len": 1, "newknob": 3}, log=lambda *_: None)
        with pytest.raises(ValueError, match="disagree"):
            check(str(tmp_path / "ref"), "eval", {"seq_len": 6}, log=lambda *_: None)
        notes = []
        check(str(tmp_path / "none"), "eval", {"seq_len": 6}, log=notes.append)
        assert len(notes) == 1


def test_artifacts_and_curves(tmp_path):
    src = tmp_path / "proof.json"
    names = {}
    for name, archive in (("port", archive_file), ("ref", jax_artifacts.archive_file)):
        out = []
        for v in range(3):
            src.write_text(json.dumps({"v": v}))
            out.append(os.path.basename(archive(str(src), str(tmp_path / name), "p/proof.json")))
        assert archive(str(tmp_path / "nope"), str(tmp_path / name), "x.json") is None
        names[name] = out
    assert names["port"] == names["ref"] == ["proof.json", "proof-1.json", "proof-2.json"]
    assert json.loads((tmp_path / "port" / "p" / "proof.json").read_text()) == {"v": 0}
    videos = tmp_path / "videos"
    videos.mkdir()
    for name in ("block2block_0_failure.gif", "block2block_1_success.gif",
                 "block2block_2_failure.gif", "block2block_3_success.gif"):
        (videos / name).write_bytes(name.encode())
    staged = {}
    for name, copy in (("port", copy_proof_videos), ("ref", jax_artifacts.copy_proof_videos)):
        copy(str(videos), str(tmp_path / f"art_{name}"), prefix="t_r1")
        paths = copy(str(videos), str(tmp_path / f"art_{name}"), prefix="t_r1")  # no clobber
        staged[name] = sorted(os.path.relpath(p, tmp_path / f"art_{name}") for p in paths)
    assert staged["port"] == staged["ref"] and len(staged["port"]) == 3
    assert copy_proof_videos(str(tmp_path / "none"), str(tmp_path / "art"), prefix="t") == []
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    with open(train_dir / "metrics.jsonl", "w") as f:
        for record in ({"step": 100, "loss": 0.5}, {"step": 50, "loss": 0.9},
                       {"step": 100, "eval_loss": 0.7, "eval_batches": 4.0}):
            f.write(json.dumps(record) + "\n")
    curves = read_scalar_curves(str(train_dir))
    assert curves == {"loss": [(50, 0.9), (100, 0.5)], "eval_loss": [(100, 0.7)]}
    assert read_scalar_curves(str(tmp_path / "empty")) == {"loss": [], "eval_loss": []}
    path = write_loss_curves(curves, str(tmp_path / "loss_curve.json"), title="t")
    assert json.loads(open(path).read()) == {
        "title": "t", "curves": {"loss": [[50, 0.9], [100, 0.5]], "eval_loss": [[100, 0.7]]}}


def _jax_script_corpus_entropy():
    """`corpus_entropy` of `scripts/policy_diagnostics.py`, compiled from the
    script's source alone (importing the script would register its flags)."""
    path = os.path.join(REPO, "scripts", "policy_diagnostics.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    (node,) = [n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "corpus_entropy"]
    namespace = {"np": np, "os": os}
    exec(compile(ast.Module(body=[node], type_ignores=[]), path, "exec"), namespace)
    return namespace["corpus_entropy"]


def test_corpus_entropy_matches_jax_script(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(5):
        ep = generate_synthetic_episode(rng, num_steps=int(rng.integers(5, 30)), height=4,
                                        width=4)
        ep["action"] = np.clip(rng.normal(0, 0.03, ep["action"].shape), -0.1, 0.1) \
            .astype(np.float32)
        save_episode(str(tmp_path / "train" / f"episode_{i}.npz"), ep)
    ref_fn = _jax_script_corpus_entropy()
    for n, vocab in ((3, 256), (200, 256), (200, 32)):
        got, want = corpus_entropy(str(tmp_path), n, vocab), ref_fn(str(tmp_path), n, vocab)
        assert sorted(got) == sorted(want)
        assert got["episodes_scanned"] == want["episodes_scanned"]
        np.testing.assert_allclose(got["per_token_entropy_nats"], want["per_token_entropy_nats"],
                                   rtol=0, atol=1e-9)
        for key in ("mean_entropy_nats",):
            assert abs(got[key] - want[key]) <= 1e-9
        for key, value in want["displayed_loss_at"].items():
            assert abs(got["displayed_loss_at"][key] - value) <= 1e-9
    with pytest.raises(FileNotFoundError):
        corpus_entropy(str(tmp_path / "none"), 3)


TINY = ["--config", "tiny", "--device", "cpu", "--episodes", "3", "--workers", "2",
        "--num_steps", "2", "--eval_episodes", "1", "--height", "32", "--width", "56",
        "--batch", "2", "--seq_len", "3", "--dtype", "float32",
        "--set", "model.image_tokenizer=tiny", "--set", "data.loader=numpy"]


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_learn_proof_cli_end_to_end(tmp_path, capsys, monkeypatch):
    workdir = str(tmp_path / "lp")
    args = TINY + ["--workdir", workdir]
    assert learn_proof.main(args + ["--stage", "collect"]) == 0
    (collected,) = [r for r in _lines(capsys) if r.get("stage") == "collect"]
    assert collected["counts"] == {"train": 3, "val": 0, "test": 0}
    assert collected["attempts"] >= 3
    assert learn_proof.main(args + ["--stage", "train"]) == 0
    with open(os.path.join(workdir, "train", "train_meta.json")) as f:
        stamped = json.load(f)
    assert stamped == {"seq_len": 3, "image_tokenizer": "tiny", "height": 32, "width": 56,
                       "dtype": "float32", "focal_gamma": 0.0, "aux_mse_weight": 0.0,
                       "embedder": "ngram", "batch": 2, "pretrained_encoder": ""}
    capsys.readouterr()
    # Resume rules: a finished stage says so; a mismatched corpus refuses.
    assert learn_proof.main(args + ["--stage", "train"]) == 0
    assert {"stage": "train", "status": "already_done", "step": 2} in _lines(capsys)
    with pytest.raises(ValueError, match="exec_noise_std"):
        learn_proof.main(args + ["--stage", "collect", "--exec_noise_std", "0.01"])
    assert learn_proof.main(args + ["--stage", "dagger", "--dagger_rounds", "1",
                                    "--dagger_episodes", "1", "--dagger_extra_steps", "2"]) == 0
    dagger_line = [r for r in _lines(capsys) if r.get("stage") == "dagger" and "rounds" in r][0]
    assert dagger_line["step"] == 4 and len(dagger_line["rounds"]) == 1
    assert dagger_line["rounds"][0]["from_checkpoint"] == 2
    assert dagger_line["engine_steps"] >= 2  # the CPU runs the plain path: no launches
    assert set(dagger_line["launches"].values()) == {0}
    assert not os.path.exists(os.path.join(workdir, "dagger_state.json"))
    assert os.path.exists(os.path.join(workdir, "dagger_rounds.json"))
    with pytest.raises(ValueError, match="disagree"):
        learn_proof.main(args + ["--stage", "eval", "--seq_len", "2"])
    capsys.readouterr()
    assert learn_proof.main(args + ["--stage", "eval"]) == 0
    arms = {r["arm"]: r for r in _lines(capsys) if r.get("arm")}
    assert sorted(arms) == ["oracle", "random", "trained"]
    with open(os.path.join(workdir, "learn_proof.json")) as f:
        summary = json.load(f)
    jax_keys = set(jax_proof.build_proof_summary(**_summary_kwargs()))
    assert set(summary) == jax_keys | {"loss_curves", "corpus_entropy"}
    assert summary["evaluated_checkpoint_step"] == 4 and summary["train_steps_requested"] == 2
    assert summary["episodes_collected"] == 4 and summary["episodes_by_split"] == {"train": 4}
    assert summary["eval_episodes"] == 1 and summary["resolution"] == [32, 56]
    assert summary["headline_protocol"]["formal_eval_seed"] == learn_proof.EVAL_SEED == 10_000
    assert summary["corpus_entropy"]["episodes_scanned"] == 4
    assert os.path.exists(os.path.join(workdir, "loss_curve.json"))
    assert sorted(os.listdir(workdir)) == ["dagger_rounds.json", "data", "eval",
                                           "learn_proof.json", "loss_curve.json", "train"]
    # The trained arm's episode video, where JAX's script writes it.
    (video,) = os.listdir(os.path.join(workdir, "eval", "trained", "videos"))
    assert video.startswith("block2block_0_") and video.endswith(".gif")
    assert len(glob.glob(os.path.join(workdir, "data", "train", "episode_*.npz"))) == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        learn_proof.main([a for a in args if a not in ("--device", "cpu")]
                         + ["--stage", "eval"])


def test_learn_proof_defaults_match_the_jax_script():
    args = learn_proof.parse_args([])
    assert (args.episodes, args.workers, args.num_steps, args.eval_episodes, args.stage) == \
        (800, 12, 20000, 20, "all")
    assert (args.dagger_rounds, args.dagger_episodes, args.dagger_beta,
            args.dagger_extra_steps, args.exec_noise_std) == (3, 40, 0.0, 5000, 0.0)
    assert (args.block_mode, args.embedder, args.image_tokenizer, args.height, args.width,
            args.batch, args.checkpoint_every, args.seq_len, args.dtype) == \
        ("BLOCK_4", "ngram", "efficientnet_b3", 128, 224, 32, 2500, 6, "bfloat16")
    assert (args.focal_gamma, args.aux_mse_weight, args.constant_lr, args.pretrained_encoder,
            args.run_tag, args.archive_dir, args.config, args.overrides, args.device) == \
        (0.0, 0.0, False, "", "r03", None, "language_table", [], "cuda")
    assert (learn_proof.EVAL_SEED, learn_proof.DAGGER_SEED) == (10_000, 30_000)
    assert learn_proof.TRAIN_META_KEYS == learn_proof.EVAL_META_KEYS + ("batch",
                                                                        "pretrained_encoder")
