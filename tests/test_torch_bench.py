"""`python -m rt1_tpu_torch.bench` and its multihost runner against the JAX
package's `bench.py` and `scripts/bench_multihost.py`, on the CPU.

* Flags: every flag of the two JAX scripts, read with `ast` from their
  sources (they are not run), is a flag of the port's counterpart with
  the same default, choices, type and action; the defaults that name a
  path are the named exceptions.
* Metric names: each mode and each A/B flag prints one headline line whose
  metric name and unit are JAX's for the same flags, JAX's name taken by
  evaluating the expression of its own headline dict from `bench.py`'s
  source; the detail lines JAX prints, and the files of `--trace` (host
  spans) and `--trace_dir` (a Chrome trace).
* `--mode env` against JAX's `env_bench`, run in this process: the same
  metric, unit and count of control steps.
* Counted results, held to the module that already computes them: the
  quant A/B's parameter bytes (`models/quant.py`), the KV-cache sweep's
  cached-vs-windowed token agreement (`serve/parity.py`), the mfu FLOPs
  (`obs/flops.py`) and the e2e batches (the windowed torch loader and the
  packed feeder, which their own tests hold to JAX's).
* Multihost: a 1-host and a 2-host gloo run whose record has the keys, the
  grids and the global batches of JAX's record (`MULTICHIP_r06.json`).
* Refusals: on a host without a card and without `--device cpu` the CLI
  raises and prints no headline.
* No stray writes: every run starts in a temporary working directory with
  the temp directory under it, and leaves the repository's root as it
  found it: the `BENCH_*.json`, `MULTICHIP_*.json` and `BASELINE.json`
  records hashed before and after, and no record or trace of the bench's
  own names there.

Every run is `--model tiny --device cpu` at 32x48 frames and a few steps.
"""

import argparse
import ast
import glob
import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from rt1_tpu_torch import bench
from rt1_tpu_torch import bench_multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(REPO, "bench.py")
JAX_MULTIHOST = os.path.join(REPO, "scripts", "bench_multihost.py")
TINY = ["--model", "tiny", "--device", "cpu", "--height", "32", "--width", "48",
        "--steps", "2", "--warmup", "1", "--windows", "1"]
CORPUS = ["--episodes", "2", "--src_height", "36", "--src_width", "64"]

# Defaults that name a path. JAX's write under /tmp or beside the sources
# (`MULTICHIP_r06.json` would overwrite the JAX package's record); the
# port's stay under the temp directory, or where --out / --workdir say.
# bench.py's TPU-only parts, the chip claim and its probe, have no flag
# (RT1_BENCH_SKIP_PROBE is an environment variable), so no flag is exempt
# for them.
PATH_DEFAULTS = {
    ("bench", "--data_dir"): lambda: os.path.join(tempfile.gettempdir(), "rt1_bench_episodes"),
    ("bench_multihost", "--workdir"): lambda: None,
    ("bench_multihost", "--out"): lambda: None,
}


# ---------------------------------------------------------------- helpers


def _jax_flags(path):
    """{flag: {"default", "choices", "type", "action"}} of every
    `add_argument` call in `path`, from its source."""
    flags = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            flags[node.args[0].value] = {
                "default": ast.literal_eval(kw["default"]) if "default" in kw else None,
                "choices": ast.literal_eval(kw["choices"]) if "choices" in kw else None,
                "type": kw["type"].id if "type" in kw else None,
                "action": kw["action"].value if "action" in kw else None,
            }
    return flags


def _own_nodes(fn):
    """The nodes of function `fn`, its nested functions' left out."""
    nested = (ast.FunctionDef, ast.Lambda)
    stack = [node for node in fn.body if not isinstance(node, nested)]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(child for child in ast.iter_child_nodes(node)
                     if not isinstance(child, nested))


def _eval(node, env):
    return eval(compile(ast.Expression(node), JAX_BENCH, "eval"), env)  # noqa: S307


def jax_headline(argv):
    """(metric, unit) of the headline JAX's `bench.py` prints for `argv`:
    its `variant` rule and its headline dict's expressions, evaluated."""
    args = bench.build_parser().parse_args(argv)
    tree = ast.parse(open(JAX_BENCH).read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    variant = next(n.value for n in _own_nodes(funcs["main"]) if isinstance(n, ast.Assign)
                   and any(getattr(t, "id", None) == "variant" for t in n.targets))
    env = {"args": args}
    env["variant"] = _eval(variant, env)
    fn = funcs[{"train": "main", "multihost": "main", "e2e": "e2e_bench", "mfu": "mfu_bench",
                "env": "env_bench", "infer": "infer_bench"}[args.mode]]
    heads = []
    for node in _own_nodes(fn):
        if isinstance(node, ast.Dict):
            keys = [getattr(k, "value", None) for k in node.keys]
            if {"metric", "unit", "vs_baseline"} <= set(keys):
                heads.append(dict(zip(keys, node.values)))
    if fn.name == "main":  # the multihost line's name is a constant, train's a variable
        heads = [h for h in heads
                 if isinstance(h["metric"], ast.Constant) == (args.mode == "multihost")]
    (head,) = heads
    metric = head["metric"]
    if isinstance(metric, ast.Name):  # `metric = f"..."` earlier in the function
        metric = next(n.value for n in _own_nodes(fn) if isinstance(n, ast.Assign)
                      and any(getattr(t, "id", None) == metric.id for t in n.targets))
    return _eval(metric, env), head["unit"].value


# The JAX package's records at the root, and the names the port's bench
# writes its records and traces under.
ROOT_RECORDS = ("BENCH_*.json", "MULTICHIP_*.json", "BASELINE.json",
                bench_multihost.RECORD_NAME, bench.TRACE_NAME)


def _root_state():
    """{name: sha256} of the files at the repository's root that match
    ROOT_RECORDS (other tests running beside this file may write other
    files there)."""
    out = {}
    for pattern in ROOT_RECORDS:
        for path in glob.glob(os.path.join(REPO, pattern)):
            with open(path, "rb") as f:
                out[os.path.basename(path)] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """A temporary working directory holding the temp directory."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TMPDIR", str(tmp))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    return tmp_path


def run_bench(argv):
    """`bench.main(argv)` in this process: (the JSON lines on stdout, those
    on stderr). The repository's root must be as it was."""
    before = _root_state()
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert bench.main(argv) == 0
    assert _root_state() == before, "a bench run wrote at the repository's root"

    def lines(text):
        return [json.loads(line) for line in text.splitlines() if line.startswith("{")]

    return lines(out.getvalue()), lines(err.getvalue()), err.getvalue()


def _one_headline(stdout):
    heads = [line for line in stdout if "metric" in line]
    assert len(heads) == 1, stdout
    return heads[0]


def _line(records, key, value):
    return next(r for r in records if r.get(key) == value)


# ------------------------------------------------------------------ flags


@pytest.mark.parametrize("name,path,parser", [
    ("bench", JAX_BENCH, bench.build_parser),
    ("bench_multihost", JAX_MULTIHOST, bench_multihost.build_parser),
])
def test_every_jax_flag_with_its_default_and_choices(name, path, parser):
    ours = {flag: action for action in parser()._actions for flag in action.option_strings}
    jax_flags = _jax_flags(path)
    assert len(jax_flags) >= (22 if name == "bench" else 12)
    for flag, spec in jax_flags.items():
        assert flag in ours, f"{name}: {flag} missing"
        action = ours[flag]
        expected = PATH_DEFAULTS.get((name, flag), lambda d=spec["default"]: d)()
        if spec["action"] == "store_true":
            assert isinstance(action, argparse._StoreTrueAction), flag
            expected = False
        assert action.default == expected, (flag, action.default, expected)
        assert action.choices == spec["choices"], flag
        assert (action.type.__name__ if action.type else None) == spec["type"], flag
    assert ours["--device"].default == "cuda" and ours["--device"].choices == ["cuda", "cpu"]


# ---------------------------------------------------------- metric names


HEADLINE_CASES = {
    "train": ["--mode", "train"],
    "infer_dense": ["--mode", "infer"],
    "infer_pallas_ab": ["--mode", "infer", "--attention_impl", "pallas",
                        "--inference_dtype", "f32,bf16,int8", "--window_sweep", "3,6"],
    "e2e": ["--mode", "e2e", *CORPUS],
    "e2e_packed_ab": ["--mode", "e2e", "--packed", "--guard", "--health",
                      "--mixed_precision", *CORPUS, "--trace", "{root}/host_trace.json",
                      "--trace_dir", "{root}/profiler"],
    "mfu_mp": ["--mode", "mfu", "--mixed_precision"],
    "env": ["--mode", "env"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each HEADLINE_CASES run once, from a temporary working directory,
    its temp directory under it."""
    root = tmp_path_factory.mktemp("bench_runs")
    tmp = root / "tmp"
    tmp.mkdir()
    cwd, saved = os.getcwd(), (os.environ.get("TMPDIR"), tempfile.tempdir)
    os.chdir(root)
    os.environ["TMPDIR"], tempfile.tempdir = str(tmp), str(tmp)
    try:
        yield {case: run_bench([a.format(root=root) for a in argv] + TINY
                               + ["--data_dir", str(root / "corpus")])
               for case, argv in HEADLINE_CASES.items()}
    finally:
        os.chdir(cwd)
        if saved[0] is None:
            os.environ.pop("TMPDIR", None)
        else:
            os.environ["TMPDIR"] = saved[0]
        tempfile.tempdir = saved[1]


@pytest.mark.parametrize("case", sorted(HEADLINE_CASES))
def test_headline_has_jax_metric_name_and_unit(runs, case):
    stdout, _, _ = runs[case]
    head = _one_headline(stdout)
    argv = [a.format(root="") for a in HEADLINE_CASES[case]] + TINY
    assert (head["metric"], head["unit"]) == jax_headline(argv)
    assert head["device"] == "cpu" and head["vs_baseline"] == 1.0
    assert isinstance(head["value"], float) and np.isfinite(head["value"])


def test_jax_headline_names_for_the_flagship():
    """The rule itself, where no flagship runs here: no suffix for the
    flagship, `_packed` only in e2e."""
    assert jax_headline(["--mode", "train"]) == ("train_steps_per_sec_per_chip", "steps/s/chip")
    assert jax_headline(["--mode", "e2e", "--packed"]) == (
        "train_steps_per_sec_per_chip_e2e_packed", "steps/s/chip")
    assert jax_headline(["--mode", "mfu", "--packed"]) == ("train_step_mfu", "%")
    assert jax_headline(["--mode", "infer", "--attention_impl", "pallas"]) == (
        "infer_step_latency_p50_pallas", "ms")


def test_detail_lines_as_jax_prints_them(runs):
    _, err, text = runs["e2e_packed_ab"]
    e2e = _line(err, "mode", "e2e_detail")
    for key in ("compute_only_steps_per_sec_per_chip", "e2e_steps_per_sec_per_chip",
                "input_stall_pct", "input_only_batches_per_sec", "guard_overhead_pct",
                "e2e_mp_steps_per_sec_per_chip", "mp_speedup_pct", "health_overhead_pct",
                "e2e_health_overhead_pct"):
        assert key in e2e, key
    assert e2e["packed"] is True and e2e["model"] == "tiny"
    assert "pack_detail" in text
    mfu = _line(runs["mfu_mp"][1], "mode", "mfu_detail")
    assert {"flops_per_step", "sec_per_step", "peak_flops_assumed", "mfu_pct", "mp_step_ms",
            "mfu_mixed_precision"} <= set(mfu)
    # --trace: the host spans of each fed step; --trace_dir: the first
    # window's torch.profiler Chrome trace.
    with open(_line(err, "mode", "host_trace")["path"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"wait_batch", "device_dispatch"} <= names
    host_trace = _line(err, "mode", "host_trace")["path"]
    with open(os.path.join(os.path.dirname(host_trace), "profiler", bench.TRACE_NAME)) as f:
        assert json.load(f)["traceEvents"]
    infer = _line(runs["infer_pallas_ab"][1], "mode", "infer_detail")
    # On the CPU the fused attention takes its plain version: no launch.
    assert infer["launches_by_variant"] == {"tensor_core": 0, "tf32x3": 0, "simple": 0}


# ------------------------------------------------------------- counted


def _tiny_master():
    return bench._master(bench.bench_config(bench.build_parser().parse_args(TINY)))


def test_quant_ab_param_bytes_are_the_serving_trees(runs):
    from rt1_tpu_torch.convert import flax_paths
    from rt1_tpu_torch.models import quant
    from rt1_tpu_torch.models.moe import router_names

    ab = _line(runs["infer_pallas_ab"][1], "metric", "infer_quant_ab")
    master = _tiny_master()
    state = master.state_dict()
    expected = {}
    for dtype, compute in (("f32", torch.float32), ("bf16", torch.bfloat16),
                           ("int8", torch.float32)):
        prepare = quant.serving_preparer(dtype, flax_paths(master), compute, "cpu",
                                         routers=router_names(master))
        expected[dtype] = quant.tree_bytes(prepare(state))
    assert {d: row["param_bytes"] for d, row in ab["per_dtype"].items()} == expected
    assert expected["bf16"] * 2 == expected["f32"] and expected["int8"] < expected["f32"]
    assert ab["per_dtype"]["bf16"]["byte_reduction_vs_f32"] == 2.0


class _StepEngine:
    """`serve/parity.py`'s engine interface over one policy step function."""

    def __init__(self, policy, cached):
        self.policy, self.cached = policy, cached

    def reset(self, sid):
        self.state = self.policy.initial_state(1, cached=self.cached)

    def act(self, sid, obs):
        step = self.policy.infer_step_cached if self.cached else self.policy.infer_step
        with torch.no_grad():
            out, self.state = step(obs, self.state)
        return {"action_tokens": out["action_tokens"].numpy(), "action": np.zeros(2)}

    def release(self, sid):
        pass


def test_kvcache_sweep_token_agreement_is_parity_agreement(runs):
    from rt1_tpu_torch.eval.restore import build_policy
    from rt1_tpu_torch.serve.parity import action_token_agreement

    _, err, text = runs["infer_pallas_ab"]
    record = _line(err, "metric", "serve_kvcache_cached_latency_growth")
    args = bench.build_parser().parse_args(TINY)
    config = bench.bench_config(args)
    master = bench._master(config)
    frame = bench._frame(config, torch.device("cpu"))
    for seq_len, row in record["per_window"].items():
        config.model.time_sequence_length = int(seq_len)
        policy = build_policy(config)
        policy.load_state_dict(master.state_dict())
        policy = policy.to(torch.bfloat16).eval()
        windowed, cached = _StepEngine(policy, False), _StepEngine(policy, True)
        fill = action_token_agreement(windowed, cached, [[frame] * int(seq_len)])
        steady = action_token_agreement(windowed, cached, [[frame] * row["steps_compared"]],
                                        skip_steps=int(seq_len))
        assert row["token_agreement_fill"] == pytest.approx(fill["agreement"], abs=1e-7)
        assert row["token_agreement_steady"] == pytest.approx(steady["agreement"], abs=1e-7)
        assert row["steps_compared"] == int(seq_len) + 2 + 4 * 8
    path = text.split("bench: wrote ")[1].split()[0]  # under the run's temp directory
    assert os.path.basename(os.path.dirname(path)).startswith("rt1_bench_")
    with open(path) as f:
        assert json.load(f)["per_window"] == record["per_window"]


def test_mfu_flops_are_obs_flops_of_the_step(runs):
    from rt1_tpu_torch.obs import flops as flops_lib
    from rt1_tpu_torch.train.train import build_model, synthetic_batch
    from rt1_tpu_torch.trainer.optim import Adam
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import train_step_fns_from_config

    mfu = _line(runs["mfu_mp"][1], "mode", "mfu_detail")
    config = bench.bench_config(bench.build_parser().parse_args(TINY))
    optimizer = Adam(steps_per_epoch=975)
    state = create_train_state(build_model(config, "cpu"), optimizer)
    fns = train_step_fns_from_config(config, optimizer)
    batch = synthetic_batch(config, 0, 0, "cpu")
    flops = flops_lib.train_step_flops(lambda: fns.train_step(state, batch, 0))
    assert mfu["flops_per_step"] == flops > 0
    assert mfu["mp_flops_per_step"] == flops  # the same matmuls and convolutions in bf16


@pytest.mark.parametrize("packed", [False, True], ids=["loader", "packed"])
def test_e2e_batches_are_the_loaders_batches(in_tmp, packed):
    from rt1_tpu_torch.data import pack as pack_lib
    from rt1_tpu_torch.data.feeder import SampleAheadFeeder
    from rt1_tpu_torch.data.pipeline import WindowedEpisodeDataset, loader_batches
    from rt1_tpu_torch.train.profile_train import bench_episodes

    argv = ["--mode", "e2e", *CORPUS, *TINY, "--data_dir", str(in_tmp / "corpus")]
    args = bench.build_parser().parse_args(argv + (["--packed"] if packed else []))
    config = bench.bench_config(args)
    feed = bench.e2e_feed(args, torch.device("cpu"), config)
    try:
        obs, actions = next(feed)
    finally:
        feed.close()
    paths = bench_episodes(args.data_dir, args.episodes, args.src_height, args.src_width)
    h, w = config.data.height, config.data.width
    if packed:
        pack_dir = os.path.dirname(paths[0]).rstrip("/") + f"_packed_{h}x{w}_n{len(paths)}"
        source = SampleAheadFeeder(pack_lib.PackedEpisodeCache(pack_dir, window=6),
                                   args.batch, seed=0)
    else:
        ds = WindowedEpisodeDataset(paths, window=6, crop_factor=0.95, height=h, width=w)
        source = loader_batches(ds.as_torch_loader(batch_size=args.batch, seed=0))
    try:
        expected = next(iter(source))
    finally:
        source.close()
    for got, want in ((obs, expected["observations"]), (actions, expected["actions"])):
        assert set(got) == set(want)
        for key in got:
            assert torch.equal(got[key], torch.as_tensor(want[key])), key
    assert obs["image"].dtype == torch.uint8 and obs["image"].shape == (8, 6, 32, 48, 3)


# ---------------------------------------------------------------- env


def test_env_mode_against_jax_env_bench(in_tmp, monkeypatch):
    """JAX's `env_bench` (which claims no chip) and the port's env mode:
    the same metric, unit and control steps (20 warm-up + steps x 20)."""
    from rt1_tpu.envs import language_table as jax_lt
    from rt1_tpu_torch.envs import language_table as port_lt

    counts = {}
    for name, module in (("jax", jax_lt), ("port", port_lt)):
        original = module.LanguageTable.step

        def counted(self, action, _original=original, _name=name):
            counts[_name] = counts.get(_name, 0) + 1
            return _original(self, action)

        monkeypatch.setattr(module.LanguageTable, "step", counted)
    monkeypatch.setenv("RT1_CHIP_GUARD_SELF", "1")  # what importing bench.py sets
    spec = importlib.util.spec_from_file_location("jax_bench_under_test", JAX_BENCH)
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    out = io.StringIO()
    with redirect_stdout(out):
        jax_bench.env_bench(argparse.Namespace(steps=3))
    jax_line = json.loads(out.getvalue().strip().splitlines()[-1])
    stdout, err, _ = run_bench(["--mode", "env", "--device", "cpu", "--steps", "3"])
    head = _one_headline(stdout)
    assert (head["metric"], head["unit"]) == (jax_line["metric"], jax_line["unit"])
    assert counts == {"jax": 20 + 3 * 20, "port": 20 + 3 * 20}
    assert _line(err, "mode", "env_detail")["control_steps"] == 60


# ----------------------------------------------------------- multihost


def _keys(tree):
    """The key paths of a nested dict (lists and leaves stop the walk)."""
    if not isinstance(tree, dict):
        return set()
    return {k for k in tree} | {f"{k}/{sub}" for k, v in tree.items() for sub in _keys(v)}


def test_multihost_record_has_jax_keys(in_tmp):
    """`--mode multihost`: a 1-host and a 2-host group of 2 gloo ranks a
    host; the record (written under the temp directory, its path on
    stderr) has the keys, grids and global batches of JAX's."""
    stdout, _, text = run_bench(["--mode", "multihost", "--device", "cpu", "--steps", "2"])
    head = _one_headline(stdout)
    assert (head["metric"], head["unit"]) == jax_headline(["--mode", "multihost"])
    assert head["vs_baseline"] == 0.0 and head["device"] == "cpu"
    path = text.split("bench_multihost: wrote ")[1].split()[0]
    assert path.startswith(str(in_tmp / "tmp"))
    with open(path) as f:
        record = json.load(f)
    assert record["methodology"]["topology"].startswith("gloo ranks on the host's CPU")
    with open(os.path.join(REPO, "MULTICHIP_r06.json")) as f:
        jax_record = json.load(f)
    assert _keys(record) == _keys(jax_record)
    for group in ("1proc", "2proc"):
        ours, theirs = record["groups"][group], jax_record["groups"][group]
        for key in ("processes", "devices_per_process", "devices_global", "mesh",
                    "global_batch"):
            assert ours[key] == theirs[key], (group, key)
        assert len(ours["per_host_data_stall_pct"]) == ours["processes"]
        assert np.isfinite(ours["final_loss"]) and ours["flops_per_step"] > 0
    assert head["value"] == record["scaling"]["examples_per_sec_ratio_2p_over_1p"] > 0
    # Twice the hosts, twice the ranks, twice the counted FLOPs a step.
    assert record["groups"]["2proc"]["flops_per_step"] == \
        2 * record["groups"]["1proc"]["flops_per_step"]


def test_multihost_out_flag_names_the_record(in_tmp):
    out = in_tmp / "records" / "multihost.json"
    record = bench_multihost.main(["--device", "cpu", "--steps", "1", "--warmup", "1",
                                   "--episodes", "2",
                                   "--workdir", str(in_tmp / "work"), "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(record))
    assert sorted(os.listdir(in_tmp / "work")) == ["g1", "g2"]


# ------------------------------------------------------------- refusals


@pytest.mark.parametrize("mode", ["train", "infer", "e2e", "mfu", "env", "multihost"])
def test_without_a_card_every_mode_raises(mode, capsys):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--mode", mode])
    assert '"metric"' not in capsys.readouterr().out


def test_multihost_runner_without_a_card_raises_before_any_rank(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_multihost.main(["--workdir", str(tmp_path / "work")])
    assert not (tmp_path / "work").exists()


def test_cli_without_a_card_exits_nonzero_with_no_headline(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "rt1_tpu_torch.bench", "--mode", "env"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr and '"metric"' not in proc.stdout
    assert os.listdir(tmp_path) == []
