"""The port's training loop on episode files (`rt1_tpu_torch/train/train.py`
`dataset_batches`, `train_and_evaluate`), on the CPU.

* The `tiny` config's first train batches from the port's
  `dataset_batches` equal the JAX loop's (`rt1_tpu.train.train.
  dataset_batches`) for the numpy loader and for the packed cache, byte
  for byte (the JAX side resizes with its native sampler).
* The data config's shared fields keep the JAX config's defaults;
  `loader="tf"` maps to the torch loader (through tf.data's bounded
  shuffle buffer, at any `shuffle_buffer`); a stale pack falls back to the
  windowed loader with a JSON line; `rlds_tf` is the RLDS pipeline, an
  unknown loader and `clip_tokens` on RT-1 raise.
* `python -m rt1_tpu_torch.train --config tiny --device cpu --set
  data.data_dir=...` trains 4 steps from files through the packed cache
  with eval on `val`, writes `data_manifest.json`, and a rerun through the
  torch loader resumes from step 4.
"""

import dataclasses
import json
import os
import subprocess
import sys
import typing

import numpy as np
import pytest
import torch

from rt1_tpu.train import train as jax_train
from rt1_tpu.train.configs import language_table as jax_language_table
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu_torch.configs import apply_override, get_config
from rt1_tpu_torch.data import episodes, pack
from rt1_tpu_torch.data.pipeline import device_feeder
from rt1_tpu_torch.train.train import check_clip_token_config, dataset_batches, train_and_evaluate

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _native_sampler(monkeypatch):
    monkeypatch.setenv("RT1_TPU_FORCE_NATIVE_SAMPLER", "1")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("lt_data")
    rng = np.random.default_rng(0)
    for split, n in (("train", 3), ("val", 2)):
        for i in range(n):
            episodes.save_episode(
                str(root / split / f"episode_{i:03d}.npz"),
                episodes.generate_synthetic_episode(rng, num_steps=10 + 2 * i, height=36,
                                                    width=64))
    (root / "manifest.json").write_text(json.dumps({"embedder": "hash", "episodes": 5}))
    return str(root)


def _configs(data_dir, **data):
    cfg = get_config("tiny")
    jcfg = jax_tiny.get_config()
    for key, value in {"data_dir": data_dir, **data}.items():
        setattr(cfg.data, key, value)
        jcfg.data[key] = value
    return cfg, jcfg


def _assert_batches_equal(a, b):
    for group in ("observations", "actions"):
        assert sorted(a[group]) == sorted(b[group])
        for k in a[group]:
            x, y = np.asarray(a[group][k]), np.asarray(b[group][k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("loader", ["numpy", "packed"])
def test_first_batches_equal_jax(data_dir, loader, tmp_path):
    data = {"loader": "numpy"}
    if loader == "packed":
        data.update(packed_cache=True, packed_cache_dir=str(tmp_path / "pack"))
        pack.pack_episodes(sorted(
            os.path.join(data_dir, "train", n) for n in os.listdir(os.path.join(data_dir, "train"))
        ), str(tmp_path / "pack"), 32, 56, 0.95)
    cfg, jcfg = _configs(data_dir, **data)
    stream = dataset_batches(cfg, "train")
    assert stream.loader == loader
    theirs = jax_train.dataset_batches(jcfg, "train")
    try:
        for _ in range(2):
            batch = next(stream.batches)
            assert batch["observations"]["image"].shape == (8, 3, 32, 56, 3)
            _assert_batches_equal(batch, next(theirs))
    finally:
        for s in (stream.batches, theirs):
            getattr(s, "close", lambda: None)()


def test_data_config_defaults_match_jax():
    for name, module in (("tiny", jax_tiny), ("language_table", jax_language_table)):
        d, jd = get_config(name).data, module.get_config().data
        for key in ("data_dir", "height", "width", "crop_factor", "loader", "shuffle_buffer",
                    "clip_tokens", "packed_cache", "packed_cache_dir", "feeder_threads",
                    "feeder_depth", "feeder_stall_timeout_s", "packed_refresh", "task_weights"):
            assert getattr(d, key) == jd[key], (name, key)
    cfg = get_config("language_table")
    apply_override(cfg, "data.crop_factor=none")
    assert cfg.data.crop_factor is None


def test_optional_fields_parse_as_their_declared_type():
    """Every Optional[X] field of every config group takes "none" and,
    from None, a value of X (its type read from the annotation)."""
    samples = {int: ("3", 3), float: ("0.5", 0.5), str: ("/some/dir", "/some/dir"),
               bool: ("true", True)}
    cfg = get_config("language_table")
    groups = [("", cfg)] + [(f.name + ".", getattr(cfg, f.name))
                            for f in dataclasses.fields(cfg)
                            if dataclasses.is_dataclass(getattr(cfg, f.name))]
    seen = []
    for prefix, node in groups:
        for name, hint in typing.get_type_hints(type(node)).items():
            args = typing.get_args(hint)
            if type(None) not in args:
                continue
            (inner,) = [a for a in args if a is not type(None)]
            apply_override(cfg, f"{prefix}{name}=none")
            assert getattr(node, name) is None
            text, want = samples[inner]
            apply_override(cfg, f"{prefix}{name}={text}")
            got = getattr(node, name)
            assert type(got) is inner and got == want, (prefix + name, got)
            seen.append(prefix + name)
    assert {"max_to_keep", "data.crop_factor", "data.packed_cache_dir",
            "data.feeder_stall_timeout_s"} <= set(seen)


def test_loader_names_and_refusals(data_dir):
    cfg, _ = _configs(data_dir, loader="tf", num_workers=0)
    stream = dataset_batches(cfg, "train")
    assert stream.loader == "torch"
    assert next(stream.batches)["observations"]["image"].dtype == torch.uint8
    bad, _ = _configs(data_dir, loader="grain")
    with pytest.raises(ValueError, match="loader"):
        dataset_batches(bad, "train")
    # "rlds_tf" is the port's RLDS windowing pipeline (no TensorFlow).
    rlds, _ = _configs(data_dir, loader="rlds_tf")
    stream = dataset_batches(rlds, "train")
    assert stream.loader == "rlds_tf"
    assert next(stream.batches)["observations"]["image"].dtype == np.uint8
    stream.batches.close()
    # CLIP tokens are ported (LAVA's "clip" encoder); an RT-1 run that asks
    # for them is refused at the config seam, as JAX's trainer refuses it.
    bad, _ = _configs(data_dir, clip_tokens=True)
    with pytest.raises(ValueError, match="instruction_tokenized_clip"):
        check_clip_token_config(bad)
    # Another shuffle buffer is no refusal: loader "tf" draws through it
    # (tf.data's bounded buffer; buffer 1 keeps the stream's order).
    buffered, _ = _configs(data_dir, loader="tf", num_workers=0, shuffle_buffer=1)
    stream = dataset_batches(buffered, "train")
    assert stream.loader == "torch"
    assert next(stream.batches)["observations"]["image"].dtype == torch.uint8
    stream.batches.close()
    with pytest.raises(FileNotFoundError):
        dataset_batches(cfg, "test")


def test_stale_pack_falls_back_with_a_json_line(data_dir, tmp_path):
    cfg, _ = _configs(data_dir, loader="numpy", packed_cache=True,
                      packed_cache_dir=str(tmp_path / "nothing"))
    records = []
    stream = dataset_batches(cfg, "train", log=records.append)
    assert stream.loader == "numpy"
    assert records[0]["status"] == "packed_cache_stale" and records[0]["fallback"] == "numpy"
    assert "manifest unreadable" in records[0]["reason"]
    assert "rt1_tpu_torch.data.pack_dataset" in records[0]["build"]


def test_train_from_files_in_process(data_dir, tmp_path):
    cfg, _ = _configs(data_dir, loader="numpy")
    cfg.per_host_batch_size = 4
    records = []
    state = train_and_evaluate(cfg, str(tmp_path), device="cpu", log=records.append)
    assert records[0]["data_loader"] == "numpy" and int(state.step) == 4
    evals = [r for r in records if "eval_loss" in r]
    assert [r["step"] for r in evals] == [2, 4] and all(np.isfinite(r["eval_loss"]) for r in evals)
    # On the CPU the attention takes the plain path: no kernel launch.
    assert all(r["eval_batches"] == 1 and r["eval_attention_launches_tensor_core"] == 0
               for r in evals)
    with open(os.path.join(str(tmp_path), "data_manifest.json")) as f:
        assert json.load(f) == {"embedder": "hash", "episodes": 5}
    feed = device_feeder(dataset_batches(cfg, "train").batches, "cpu")
    obs, _ = next(feed)
    assert obs["image"].shape == (4, 3, 32, 56, 3)
    feed.close()


def _cli(workdir, *sets):
    args = [sys.executable, "-m", "rt1_tpu_torch.train", "--config", "tiny", "--workdir",
            workdir, "--device", "cpu"]
    for s in sets:
        args += ["--set", s]
    proc = subprocess.run(args, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]


def test_train_cli_from_files_resumes(data_dir, tmp_path):
    pack_dir = str(tmp_path / "pack")
    pack.pack_episodes(sorted(os.path.join(data_dir, "train", n)
                              for n in os.listdir(os.path.join(data_dir, "train"))),
                       pack_dir, 32, 56, 0.95)
    workdir = str(tmp_path / "run")
    base = (f"data.data_dir={data_dir}", "per_host_batch_size=4")
    first = _cli(workdir, *base, "data.packed_cache=True", f"data.packed_cache_dir={pack_dir}")
    # The val split has no pack at that directory: eval falls back, loudly.
    assert first[0]["status"] == "packed_cache_stale" and first[0]["split"] == "val"
    assert first[1]["status"] == "start" and first[1]["data_loader"] == "packed"
    assert [r["step"] for r in first if "eval_loss" in r] == [2, 4]
    assert first[-1]["checkpoint_step"] == 4
    assert os.path.exists(os.path.join(workdir, "data_manifest.json"))
    second = _cli(workdir, *base, "num_steps=6", "data.num_workers=1")
    assert second[0]["restored_step"] == 4 and second[0]["data_loader"] == "torch"
    assert [r["step"] for r in second if "eval_loss" in r] == [6]
    assert second[-1]["checkpoint_step"] == 6 and second[-1]["updates"] == 6
