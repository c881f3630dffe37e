"""The port's run report (`python -m rt1_tpu_torch.obs.run_report`) against
the JAX package's (`scripts/run_report.py`), on the same canned artifacts.

* Every case of `tests/test_run_report.py` runs again with the port's
  module in the JAX module's place (its canned workdirs, its assertions);
  the golden case keeps its assertions with the port's scalar-source note.
* Each rendered section equals JAX's `render_report` on identical inputs
  (each package's own loaders), except the two scalar sections, whose
  source differs: the port reads `<workdir>/metrics.jsonl`.
* The scalar sections are held on a canned `metrics.jsonl`: the latest
  value of each scalar, its step, a torn line skipped.
"""

import inspect
import json
import os
import sys

import pytest

import tests.test_run_report as jax_cases
from rt1_tpu_torch.obs import run_report

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
import run_report as jax_run_report  # noqa: E402

# The scalar sections (the port reads them from metrics.jsonl).
SCALAR_SECTIONS = ("## Model health (last log step)", "## Last training scalars")
MIRRORED = [name for name, fn in inspect.getmembers(jax_cases, inspect.isfunction)
            if name.startswith("test_") and fn.__module__ == jax_cases.__name__
            and name != "test_report_golden_sections"]


def test_every_jax_case_is_mirrored():
    assert len(MIRRORED) + 1 == 21


@pytest.mark.parametrize("name", MIRRORED)
def test_jax_case_on_the_port(name, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(jax_cases, "run_report", run_report)
    case = getattr(jax_cases, name)
    fixtures = {"tmp_path": tmp_path, "capsys": capsys, "monkeypatch": monkeypatch}
    case(**{arg: fixtures[arg] for arg in inspect.signature(case).parameters})


def test_report_golden_sections(tmp_path):
    """JAX's golden case, with the port's note for a workdir without scalars."""
    wd = jax_cases._canned_workdir(tmp_path)
    goodput = run_report.load_goodput(wd)
    flight = run_report.load_flight(wd)
    report = run_report.render_report(wd, goodput, flight, tb=None, tail=4)
    lines = report.splitlines()
    assert "Wall time: 47.0 s" in report
    row = next(ln for ln in lines if ln.startswith("init"))
    assert row.startswith("init                  6.00   12.8%")
    assert "model/dataset/state setup" in row
    row = next(ln for ln in lines if ln.startswith("rollback_replay"))
    assert "4.00" in row and "steps re-run after guard rollback" in row
    assert any(ln.startswith("step") and "GOODPUT" in ln for ln in lines)
    assert "Goodput 16.0% / badput 84.0% of wall time." in report
    assert "MFU" in report and "1.5e+09 FLOPs/step" in report
    assert "1 rollback(s), 4 step(s) replayed" in report
    assert "PREEMPTED" in report
    assert "Dump reason: preempt — 8 of 13 recorded steps retained." in report
    assert "      42      31.2    12.5        2.08" in report
    assert "      39      31.2    12.5           -" in report
    assert "health/logit_entropy" in report and "2.4587" in report
    assert "Guard at the end: 1 device skips, 1 rollbacks." in report
    # No metrics.jsonl: a note, not a crash.
    assert "No metrics.jsonl scalars readable" in report
    assert run_report.load_tb_scalars(wd) is None


def _sections(text):
    """{heading: body lines} of a rendered report."""
    out, heading = {}, None
    for line in text.splitlines():
        if line.startswith("## "):
            heading = line
            out[heading] = []
        elif heading is not None:
            out[heading].append(line)
    return out


def _render_both(wd):
    def render(module):
        return module.render_report(
            wd, module.load_goodput(wd), module.load_flight(wd), None, tail=4,
            serve=module.load_serve(wd), eval_matrix=module.load_eval_matrix(wd),
            multichip=module.load_multichip(wd), deploy=module.load_deploy(wd),
            obs=module.load_obs(wd))
    return render(run_report), render(jax_run_report)


@pytest.mark.parametrize("canned", ["_canned_workdir", "_canned_serve_workdir",
                                    "_canned_deploy_workdir", "_canned_obs_workdir",
                                    "multichip", "quant_elastic_migration_matrix"])
def test_sections_equal_jax(canned, tmp_path):
    if canned == "multichip":
        wd = jax_cases._canned_workdir(tmp_path)
        jax_cases._canned_multichip(wd)
    elif canned == "quant_elastic_migration_matrix":
        # Every optional serve record and the eval matrix in one workdir,
        # as the JAX cases' own canned-record tests write them.
        wd = str(tmp_path / "all")
        os.makedirs(wd)
        for name in ("test_serve_quant_bench_renders_dtype_table",
                     "test_serve_elastic_bench_renders_timeline_and_cost",
                     "test_serve_migration_bench_renders_event_table",
                     "test_eval_matrix_section_renders_table"):
            os.makedirs(tmp_path / name)
            getattr(jax_cases, name)(tmp_path / name)
            for root, _, files in os.walk(tmp_path / name):
                for entry in files:
                    with open(os.path.join(root, entry), "rb") as f, \
                            open(os.path.join(wd, entry), "wb") as g:
                        g.write(f.read())
    else:
        wd = getattr(jax_cases, canned)(tmp_path)
    ours, theirs = _render_both(wd)
    a, b = _sections(ours), _sections(theirs)
    assert list(a) == list(b)
    compared = [h for h in a if h not in SCALAR_SECTIONS]
    assert compared
    for heading in compared:
        assert a[heading] == b[heading], heading
    assert ours.splitlines()[0] == theirs.splitlines()[0]


def _write_metrics(wd, records, torn=False):
    with open(os.path.join(wd, "metrics.jsonl"), "w") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")
        if torn:
            f.write('{"step": 9, "loss": 0.1')


def test_scalar_sections_from_metrics_jsonl(tmp_path):
    wd = str(tmp_path)
    _write_metrics(wd, [
        {"step": 1, "loss": 2.0, "grad_norm": 4.0, "steps_per_sec": 3.5, "health/logit_entropy": 1.5},
        {"step": 2, "loss": 1.5, "eval_loss": 1.75, "stall_pct": 12.5},
        {"step": 3, "loss": 1.25, "health/logit_entropy": 1.25, "health/token_acc/dim0": 0.5,
         "examples_per_sec": 28.0, "preempted": True},
    ], torn=True)
    tb = run_report.load_tb_scalars(wd)
    assert tb["loss"] == (3, 1.25) and tb["eval_loss"] == (2, 1.75)
    assert tb["grad_norm"] == (1, 4.0) and "preempted" not in tb
    report = run_report.render_report(wd, None, None, tb)
    lines = report.splitlines()
    assert "As of step 3:" in report
    entropy = next(ln for ln in lines if "health/logit_entropy" in ln)
    assert entropy.split() == ["health/logit_entropy", "1.25"]
    scalars = _sections(report)["## Last training scalars"]
    assert [ln.split()[0] for ln in scalars if ln.strip()] == \
        ["loss", "eval_loss", "grad_norm", "stall_pct", "steps_per_sec", "examples_per_sec"]
    assert "  loss                            1.25   (step 3)" in lines
    # Without health/* scalars the health section says the pack was off.
    _write_metrics(wd, [{"step": 4, "loss": 1.0}])
    report = run_report.render_report(wd, None, None, run_report.load_tb_scalars(wd))
    assert "No health/* scalars in metrics.jsonl" in report


def test_main_on_a_port_train_workdir(tmp_path, capsys):
    """`python -m rt1_tpu_torch.obs.run_report` over a tiny port training
    run's workdir: goodput, scalars from its metrics.jsonl, no flight dump."""
    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.train.train import train_and_evaluate

    cfg = get_config("tiny")
    cfg.num_steps = 2
    train_and_evaluate(cfg, str(tmp_path), device="cpu", log=lambda record: None)
    run_report.main(["--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "Goodput" in out and "flight_record.jsonl not found" in out
    assert "  loss  " in out and "(step 2)" in out
