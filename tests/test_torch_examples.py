"""The port's examples and tutorial (`examples/torch/`) run on the CPU at
their toy sizes, importing nothing of JAX and nothing of `rt1_tpu`.

Each runs in a fresh interpreter that first blocks `jax`, `jaxlib`, `flax`
and `rt1_tpu` (by exact name), as `tests/test_torch_imports.py` does, and
checks at the end that none of them was imported:

* `environment_example.py`: a random rollout and the frame as a GIF;
* `dataset_example.py`: oracle demos, then a batch of the windowed loader;
* `tutorial.ipynb`: every code cell in order, with the device set to the
  CPU, through the same lifecycle as `examples/tutorial.ipynb` (its
  sections in the same order);
* `parallelism_example.py --device cpu`: one line a mode, in the order of
  `examples/parallelism_example.py`'s modes, each mode on the host with a
  finite loss and gradient norm
  and no attention-kernel launch, the four dense modes at one loss
  (`tests/test_torch_parallelism_example.py` holds the numbers to JAX's).
"""

import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch")

_RUNNER = r"""
import json
import runpy
import sys

BLOCKED = ("jax", "jaxlib", "flax", "rt1_tpu")


def blocked(name):
    return name.split(".")[0] in BLOCKED


for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked by test_torch_examples: {name}")


sys.meta_path.insert(0, Blocker())
target, args = sys.argv[1], sys.argv[2:]
if target.endswith(".ipynb"):
    with open(target) as f:
        notebook = json.load(f)
    namespace = {"__name__": "__main__"}
    for i, cell in enumerate(notebook["cells"]):
        if cell["cell_type"] == "code":
            exec(compile("".join(cell["source"]), f"{target}[{i}]", "exec"), namespace)
else:
    sys.argv = [target] + args
    runpy.run_path(target, run_name="__main__")
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
print("EXAMPLE_OK")
"""


def _run(name, *args, tmp_path):
    env = dict(os.environ, RT1_TUTORIAL_DEVICE="cpu", TMPDIR=str(tmp_path))
    env.pop("PYTHONPATH", None)  # the examples put the repo on the path themselves
    proc = subprocess.run([sys.executable, "-c", _RUNNER, os.path.join(EXAMPLES, name), *args],
                          cwd=EXAMPLES, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "EXAMPLE_OK" in proc.stdout, \
        proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_environment_example(tmp_path):
    out = _run("environment_example.py", "--out", str(tmp_path / "frame.gif"),
               tmp_path=tmp_path)
    assert "instruction: " in out and "final frame: (444, 640, 3)" in out
    with open(tmp_path / "frame.gif", "rb") as f:
        assert f.read(6) == b"GIF89a"


def test_dataset_example(tmp_path):
    out = _run("dataset_example.py", "--data_dir", str(tmp_path / "data"), "--episodes", "2",
               tmp_path=tmp_path)
    assert "collecting 2 oracle episodes" in out and "2 episodes, " in out
    for line in ("observations/image: (4, 6, 128, 228, 3) torch.uint8",
                 "observations/natural_language_embedding: (4, 6, 512) torch.float32",
                 "actions/terminate_episode: (4, 6) torch.int32",
                 "actions/action: (4, 6, 2) torch.float32"):
        assert line in out, out


def _headings(path):
    with open(path) as f:
        notebook = json.load(f)
    return [line.split(".", 1)[0] for cell in notebook["cells"]
            if cell["cell_type"] == "markdown"
            for line in "".join(cell["source"]).splitlines() if line.startswith("## ")]


def test_tutorial_follows_the_jax_tutorials_sections():
    port = _headings(os.path.join(EXAMPLES, "tutorial.ipynb"))
    assert port == _headings(os.path.join(REPO, "examples", "tutorial.ipynb"))
    assert port == [f"## {i}" for i in range(1, 7)]


def test_tutorial_runs_on_the_cpu(tmp_path):
    out = _run("tutorial.ipynb", tmp_path=tmp_path)
    lines = out.splitlines()
    assert lines[0].startswith("cpu ")
    out_dir = lines[0].split()[-1]
    assert os.path.dirname(out_dir) == str(tmp_path)
    for name in ("board.gif", "oracle_plan.gif"):
        with open(os.path.join(out_dir, name), "rb") as f:
            assert f.read(6) == b"GIF89a"
    assert "30264" in out and "ran 5 policy-controlled steps" in out
    losses = [float(line.split("'loss': ")[1].split(",")[0]) for line in lines
              if "'loss': " in line]
    assert len(losses) == 3 and all(map(math.isfinite, losses))


def test_parallelism_example_runs_every_mode_on_the_cpu(tmp_path):
    out = _run("parallelism_example.py", "--device", "cpu", tmp_path=tmp_path)
    lines = [line for line in out.splitlines() if " mesh={" in line]
    from test_torch_parallelism_example import jax_modes

    assert [line.split(" mesh=")[0].rstrip() for line in lines] == \
        [label for label, _, _ in jax_modes()]
    fields = [dict(item.split("=", 1) for item in line.split("} ", 1)[1].split())
              for line in lines]
    for line, field in zip(lines, fields):
        assert math.isfinite(float(field["loss"])) and math.isfinite(float(field["grad_norm"]))
        assert field["device"] == "cpu" and field["attention_launches"] == "0", line
    assert len({field["loss"] for field in fields[:4]}) == 1, lines


def test_parallelism_example_defaults_to_the_card(tmp_path):
    """Without `--device` the example runs on the card, and refuses on a
    host without one before it starts a rank."""
    import torch

    if torch.cuda.is_available():
        return  # the default device is usable here
    proc = subprocess.run([sys.executable, os.path.join(EXAMPLES, "parallelism_example.py")],
                          cwd=EXAMPLES, env=dict(os.environ, TMPDIR=str(tmp_path)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr, proc.stderr[-2000:]
    assert not os.listdir(tmp_path)   # no rank's rendezvous was made
