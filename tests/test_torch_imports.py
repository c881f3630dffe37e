"""Guard: the port imports nothing of JAX and nothing of `rt1_tpu`.

A fresh interpreter blocks jax, flax, optax, orbax, tensorflow,
ml_collections, absl, cv2, PIL, imageio, matplotlib, msgpack, google
(protobuf), tensorflow_datasets, crc32c and the top-level module `rt1_tpu`
(by exact name: `rt1_tpu_torch` shares its prefix), then
imports every module of `rt1_tpu_torch` and `chip_smoke.py`. The machine
with the card has none of those packages (scipy it has, and the env's arm
kinematics use it), and `rt1_tpu/__init__.py` takes a chip-claim lock.
"""

import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflow",
           "ml_collections", "absl", "cv2", "PIL", "imageio", "matplotlib", "msgpack",
           "google", "tensorflow_datasets", "crc32c", "rt1_tpu")


def blocked(name):
    return name.split(".")[0] in BLOCKED


for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked by test_torch_imports: {name}")


sys.meta_path.insert(0, Blocker())

import rt1_tpu_torch

names = ["rt1_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(rt1_tpu_torch.__path__, "rt1_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401

leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
print("IMPORTED", len(names))
"""


def _port_modules():
    pkg = os.path.join(REPO, "rt1_tpu_torch")
    return ["rt1_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([pkg], "rt1_tpu_torch.")
    ]


def test_port_imports_without_jax_or_rt1_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"IMPORTED {len(_port_modules())}" in proc.stdout


def test_blocker_is_exact_on_the_rt1_tpu_name():
    """`rt1_tpu_torch` must import while `rt1_tpu` is blocked, and the probe
    must really block `rt1_tpu` itself."""
    env = dict(os.environ, PYTHONPATH=REPO)
    probe = _PROBE.split("import rt1_tpu_torch\n")[0] + "import rt1_tpu\n"
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "blocked by test_torch_imports: rt1_tpu" in proc.stderr
    assert len(_port_modules()) > 20


def test_training_modules_are_among_those_imported():
    names = set(_port_modules())
    for name in ("rt1_tpu_torch.ops.dropout", "rt1_tpu_torch.trainer.optim",
                 "rt1_tpu_torch.trainer.state", "rt1_tpu_torch.trainer.train",
                 "rt1_tpu_torch.trainer.checkpoints", "rt1_tpu_torch.trainer.metrics",
                 "rt1_tpu_torch.train.train", "rt1_tpu_torch.train.__main__"):
        assert name in names, name


def test_data_modules_are_among_those_imported():
    names = set(_port_modules())
    for name in ("rt1_tpu_torch.data.episodes", "rt1_tpu_torch.data.native",
                 "rt1_tpu_torch.data.pipeline", "rt1_tpu_torch.data.pack",
                 "rt1_tpu_torch.data.feeder", "rt1_tpu_torch.data.pack_dataset"):
        assert name in names, name


def test_eval_modules_are_among_those_imported():
    names = set(_port_modules())
    for name in ("rt1_tpu_torch.envs", "rt1_tpu_torch.envs.constants", "rt1_tpu_torch.envs.blocks",
                 "rt1_tpu_torch.envs.language", "rt1_tpu_torch.envs.task_info",
                 "rt1_tpu_torch.envs.utils.pose3d", "rt1_tpu_torch.envs.utils.xarm",
                 "rt1_tpu_torch.envs.backends", "rt1_tpu_torch.envs.backends.kinematic",
                 "rt1_tpu_torch.envs.rendering", "rt1_tpu_torch.envs.language_table",
                 "rt1_tpu_torch.envs.rewards", "rt1_tpu_torch.envs.rewards.base",
                 "rt1_tpu_torch.envs.rewards.block2block",
                 "rt1_tpu_torch.envs.rewards.block2block_relative",
                 "rt1_tpu_torch.envs.rewards.block2location",
                 "rt1_tpu_torch.envs.rewards.block2relativelocation",
                 "rt1_tpu_torch.envs.rewards.corner", "rt1_tpu_torch.envs.rewards.play",
                 "rt1_tpu_torch.envs.rewards.point2block",
                 "rt1_tpu_torch.envs.rewards.separate_blocks",
                 "rt1_tpu_torch.envs.oracles", "rt1_tpu_torch.envs.oracles.rrt_star",
                 "rt1_tpu_torch.envs.oracles.push_oracle", "rt1_tpu_torch.eval.wrappers",
                 "rt1_tpu_torch.eval.policy", "rt1_tpu_torch.eval.evaluate",
                 "rt1_tpu_torch.eval.main", "rt1_tpu_torch.eval.__main__"):
        assert name in names, name


def test_learning_proof_modules_are_among_those_imported():
    names = set(_port_modules())
    for name in ("rt1_tpu_torch.data.collect", "rt1_tpu_torch.data.normalization",
                 "rt1_tpu_torch.data.dagger", "rt1_tpu_torch.train.dagger_loop",
                 "rt1_tpu_torch.train.meta", "rt1_tpu_torch.train.proof_config",
                 "rt1_tpu_torch.train.pretrain_vision", "rt1_tpu_torch.train.learn_proof",
                 "rt1_tpu_torch.train.proof_arm", "rt1_tpu_torch.eval.proof",
                 "rt1_tpu_torch.eval.diagnostics",
                 "rt1_tpu_torch.utils", "rt1_tpu_torch.utils.curves",
                 "rt1_tpu_torch.utils.artifacts"):
        assert name in names, name


def test_serve_mode_modules_are_among_those_imported():
    names = set(_port_modules())
    for name in ("rt1_tpu_torch.models.quant", "rt1_tpu_torch.serve.parity",
                 "rt1_tpu_torch.serve.migrate", "rt1_tpu_torch.serve.__main__"):
        assert name in names, name


def test_fleet_modules_are_among_those_imported():
    names = set(_port_modules())
    for name in ("rt1_tpu_torch.obs", "rt1_tpu_torch.obs.prometheus", "rt1_tpu_torch.obs.trace",
                 "rt1_tpu_torch.obs.recorder", "rt1_tpu_torch.obs.slo",
                 "rt1_tpu_torch.obs.quantiles", "rt1_tpu_torch.resilience.faults",
                 "rt1_tpu_torch.serve.reqtrace", "rt1_tpu_torch.serve.autoscale",
                 "rt1_tpu_torch.serve.router", "rt1_tpu_torch.serve.stub",
                 "rt1_tpu_torch.serve.fleet"):
        assert name in names, name


MOE_AND_LAVA_MODULES = (
    "rt1_tpu_torch.models.moe", "rt1_tpu_torch.ops.remat", "rt1_tpu_torch.text",
    "rt1_tpu_torch.text.clip_bpe", "rt1_tpu_torch.models.lava",
    "rt1_tpu_torch.models.lava.blocks", "rt1_tpu_torch.models.lava.resnet",
    "rt1_tpu_torch.models.lava.clip_text", "rt1_tpu_torch.models.lava.lava",
    "rt1_tpu_torch.models.lava.pixel", "rt1_tpu_torch.trainer.bc",
)


def test_moe_and_lava_modules_are_among_those_imported():
    names = set(_port_modules())
    for name in MOE_AND_LAVA_MODULES:
        assert name in names, name


PARALLEL_MODULES = tuple(f"rt1_tpu_torch.parallel.{m}" for m in (
    "mesh", "sharding", "plan", "distributed", "collectives", "reshard", "ring_attention",
    "tensor_parallel", "partition", "pipeline"))


def test_parallel_modules_are_among_those_imported():
    names = set(_port_modules())
    for name in PARALLEL_MODULES:
        assert name in names, name


def test_clip_bpe_runs_without_the_regex_package():
    """The card's machine has no `regex`: with it blocked too, the port's
    CLIP BPE takes the stdlib split and still tokenizes."""
    env = dict(os.environ, PYTHONPATH=REPO)
    probe = _PROBE.replace('"crc32c", "rt1_tpu")', '"crc32c", "rt1_tpu", "regex")')
    assert probe != _PROBE
    probe = probe.split("import rt1_tpu_torch\n")[0] + (
        "from rt1_tpu_torch.text import clip_bpe\n"
        "assert clip_bpe._re is None\n"
        "print('IDS', clip_bpe.default_tokenizer().tokenize_text(\"It's red\")[0][:6].tolist())\n")
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    from rt1_tpu_torch.text import clip_bpe

    want = clip_bpe.default_tokenizer().tokenize_text("It's red")[0][:6].tolist()
    assert f"IDS {want}" in proc.stdout, proc.stdout


SLICE_16_MODULES = (
    "rt1_tpu_torch.obs.profile", "rt1_tpu_torch.obs.alerts_proof",
    "rt1_tpu_torch.train.profile_train", "rt1_tpu_torch.train.perception_probe",
    "rt1_tpu_torch.envs.font", "rt1_tpu_torch.envs.oracles.plot", "rt1_tpu_torch.eval.video",
    "rt1_tpu_torch.eval.embedding", "rt1_tpu_torch.eval.diagnostics",
    "rt1_tpu_torch.utils.flax_msgpack",
)


def test_profiler_proof_and_eval_extra_modules_are_among_those_imported():
    names = set(_port_modules())
    for name in SLICE_16_MODULES:
        assert name in names, name


def test_new_entry_points_default_to_the_card(tmp_path):
    """Each entry point that runs the model refuses on a machine without a
    card unless asked for the CPU (`--device cpu`; the alerts proof's
    `--stub` runs no model)."""
    import torch

    if torch.cuda.is_available():
        return  # the default device is usable here
    env = dict(os.environ, PYTHONPATH=REPO)
    for module, args in (("rt1_tpu_torch.train.profile_train", ["--model", "tiny"]),
                         ("rt1_tpu_torch.train.perception_probe",
                          ["--frames", "4", "--out_dir", str(tmp_path)]),
                         ("rt1_tpu_torch.obs.alerts_proof", ["--config", "tiny"]),
                         ("rt1_tpu_torch.eval.diagnostics", ["--workdir", str(tmp_path)]),
                         ("rt1_tpu_torch.train.proof_arm", ["--workdir", str(tmp_path)])):
        proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr, \
            (module, proc.stderr[-2000:])


RLDS_MODULES = ("rt1_tpu_torch.data.codecs", "rt1_tpu_torch.data.tfrecord",
                "rt1_tpu_torch.data.tfds", "rt1_tpu_torch.data.convert_rlds",
                "rt1_tpu_torch.data.rlds_pipeline")


def test_rlds_modules_are_among_those_imported():
    names = set(_port_modules())
    for name in RLDS_MODULES:
        assert name in names, name


def test_rlds_reader_decodes_the_fixture_without_tf_or_protobuf():
    """With TensorFlow, tensorflow_datasets, protobuf and PIL blocked, the
    port reads the TFDS fixture, decodes its JPEG and PNG frames to the
    pixels TF decoded, and converts it."""
    env = dict(os.environ, PYTHONPATH=REPO)
    probe = _PROBE.split("import rt1_tpu_torch\n")[0] + (
        "import os, tempfile\n"
        "import numpy as np\n"
        "from rt1_tpu_torch.data import convert_rlds, tfds\n"
        "fx = os.path.join('tests', 'fixtures', 'tfds_language_table')\n"
        "z = np.load(os.path.join(fx, 'tf_decoded.npz'))\n"
        "for enc in ('jpeg', 'png'):\n"
        "    ep = next(tfds.TfdsDirectory(os.path.join(fx, enc)).episodes('train'))\n"
        "    assert (ep['steps'].dense()['observation']['rgb'][0] == z[enc + '_0_0']).all()\n"
        "out = tempfile.mkdtemp()\n"
        "assert convert_rlds.convert(os.path.join(fx, 'jpeg'), out, num_train=2, num_val=1) == 3\n"
        "leaked = sorted(m for m in sys.modules if blocked(m))\n"
        "assert not leaked, leaked\n"
        "print('RLDS OK')\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "RLDS OK" in proc.stdout, proc.stdout + proc.stderr


def test_bench_modules_are_among_those_imported():
    """The benchmark CLI and its multihost runner (`python -m
    rt1_tpu_torch.bench`), imported by the probe above with JAX blocked."""
    names = set(_port_modules())
    for name in ("rt1_tpu_torch.bench", "rt1_tpu_torch.bench_multihost"):
        assert name in names, name
