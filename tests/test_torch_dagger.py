"""The port's DAgger collection and its outer loop against the JAX package's.

* `collect_dagger_episode` with a `tiny` RT-1 on weights carried across by
  `convert.py` (the JAX side runs the Pallas kernel in interpret mode, the
  port its plain version), BLOCK_4, 32x56, window 3, beta 0.5 from equal
  generators: step for step the logits within 1e-6 of the largest logit
  (these random weights give logits near 20, where one float32 ulp is
  2e-6), the executed actions within 1e-6 (the bound of
  `tests/test_torch_eval.py`) and equal
  in which of policy and oracle drove, the oracle labels within 1e-6, the
  flags, instruction and text equal, the native frames under the
  renderer's bound. As in `tests/test_torch_eval.py`, the port's crop
  wrapper resizes with cv2 here, so both policies see the same frames.
* `collect_dagger_batch` with a constant policy: equal (episodes,
  successes, attempts) and equal episodes.
* `append_episodes_to_corpus`: equal counts, manifests and files, the
  orphan reconciliation included; no manifest raises in both.
* `run_dagger_loop`: the crash and resume cases of `tests/test_dagger_loop.py`
  on the port's loop, and a state file written by one package's loop
  resumed by the other's.
"""

import json
import os

import numpy as np
import pytest

from rt1_tpu.data import collect as jax_collect
from rt1_tpu.data import dagger as jax_dagger
from rt1_tpu.envs import blocks as jax_blocks
from rt1_tpu.envs.oracles import RRTPushOracle as JaxRRTPushOracle
from rt1_tpu.eval import evaluate as jax_evaluate
from rt1_tpu.eval.policy import RT1EvalPolicy as JaxRT1EvalPolicy
from rt1_tpu.train import dagger_loop as jax_loop
from rt1_tpu_torch.data import dagger
from rt1_tpu_torch.data.episodes import load_episode, write_manifest
from rt1_tpu_torch.envs import blocks
from rt1_tpu_torch.envs.oracles import RRTPushOracle
from rt1_tpu_torch.eval import evaluate, wrappers
from rt1_tpu_torch.eval.policy import RT1EvalPolicy
from rt1_tpu_torch.train import dagger_loop
from test_torch_envs_render import _check_frame
from test_torch_eval import _cv2_crop_resize_batch, _tiny_pair

TOL = 1e-6
H, W = 32, 56


def _env_pair(seed):
    kwargs = dict(reward_name="block2block", seed=seed, embedder="hash", target_height=H,
                  target_width=W, sequence_length=3)
    port = evaluate.build_eval_env(block_mode=blocks.BlockMode.BLOCK_4,
                                   history_keys=dagger.DAGGER_HISTORY_KEYS, **kwargs)
    ref = jax_evaluate.build_eval_env(block_mode=jax_blocks.BlockMode.BLOCK_4,
                                      history_keys=jax_dagger.DAGGER_HISTORY_KEYS, **kwargs)
    return port, ref


class Recording:
    """Passes `step` through and keeps each executed action."""

    def __init__(self, env):
        self._env = env
        self.executed = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self):
        return self._env.reset()

    def step(self, action):
        self.executed.append(np.asarray(action, np.float32).copy())
        return self._env.step(action)


class _RecordingSteps(dict):
    """The JAX engine's compiled bucket steps, each wrapped to keep lane 0's
    action logits."""

    def __init__(self, logits):
        super().__init__()
        self.logits = logits

    def __getitem__(self, bucket):
        step = super().__getitem__(bucket)

        def recording(*args):
            out, state = step(*args)
            self.logits.append(np.asarray(out["action_logits"][0], np.float64))
            return out, state
        return recording


def _record_port_logits(policy, logits):
    infer_step = policy.infer_step

    def recording(obs, state, **kwargs):  # the engine passes per_row
        out, new_state = infer_step(obs, state, **kwargs)
        logits.append(out["action_logits"][0].double().numpy())
        return out, new_state

    policy.infer_step = recording


def hold_dagger_episode(port, ref, what):
    assert sorted(port) == sorted(ref), what
    for key in ref:
        assert port[key].shape == ref[key].shape and port[key].dtype == ref[key].dtype, \
            (what, key)
        if key == "rgb":
            for t, (p, r) in enumerate(zip(port[key], ref[key])):
                _check_frame(p, r, f"{what} frame {t}")
        elif key == "action":
            np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=TOL, err_msg=what)
        else:
            assert port[key].tobytes() == ref[key].tobytes(), (what, key)


def test_collect_dagger_episode_matches_jax_step_for_step(monkeypatch):
    monkeypatch.setattr(wrappers, "crop_resize_batch", _cv2_crop_resize_batch)
    jm, variables, model = _tiny_pair(seed=17, h=H, w=W)
    port_logits, ref_logits = [], []
    _record_port_logits(model, port_logits)
    port_policy, ref_policy = RT1EvalPolicy(model), JaxRT1EvalPolicy(jm, variables)
    ref_policy._engine._compiled = _RecordingSteps(ref_logits)
    port_env, ref_env = (Recording(e) for e in _env_pair(seed=3))
    port_oracle = RRTPushOracle(port_env, use_ee_planner=True)
    ref_oracle = JaxRRTPushOracle(ref_env, use_ee_planner=True)
    port_rng, ref_rng = np.random.default_rng(8), np.random.default_rng(8)
    steps = 0
    for episode in range(2):
        port, port_ok = dagger.collect_dagger_episode(port_env, port_policy, port_oracle,
                                                      max_steps=6, beta=0.5, rng=port_rng)
        ref, ref_ok = jax_dagger.collect_dagger_episode(ref_env, ref_policy, ref_oracle,
                                                        max_steps=6, beta=0.5, rng=ref_rng)
        assert (port is None) == (ref is None) and port_ok == ref_ok, episode
        if port is None:
            continue
        hold_dagger_episode(port, ref, f"episode {episode}")
        steps += len(port["action"])
    assert steps >= 6
    # Logits of every policy step (warm-up excluded on the port's side: the
    # JAX engine compiles without running).
    port_logits = port_logits[len(port_logits) - len(ref_logits):]
    assert len(ref_logits) == len(port_env.executed) == steps
    for i, (p, r) in enumerate(zip(port_logits, ref_logits)):
        bound = TOL * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(p, r, rtol=0, atol=bound, err_msg=f"step {i} logits")
    executed_port, executed_ref = np.stack(port_env.executed), np.stack(ref_env.executed)
    # Within 1e-6 everywhere: beta 0.5 handed the same steps to the oracle
    # in both packages (the two actors' actions differ far more than that).
    np.testing.assert_allclose(executed_port, executed_ref, rtol=0, atol=TOL)
    assert port_rng.random() == ref_rng.random()


class ConstantPolicy:
    def __init__(self, action=(0.004, 0.0)):
        self._action = np.asarray(action, np.float32)

    def reset(self):
        pass

    def action(self, observation):
        assert "rgb_sequence" in observation
        return self._action


def test_collect_dagger_batch_matches_jax():
    port_env, ref_env = _env_pair(seed=11)
    port = dagger.collect_dagger_batch(port_env, ConstantPolicy(),
                                       RRTPushOracle(port_env, use_ee_planner=True), 2,
                                       rng=np.random.default_rng(1), max_steps=5, beta=0.3)
    ref = jax_dagger.collect_dagger_batch(ref_env, ConstantPolicy(),
                                          JaxRRTPushOracle(ref_env, use_ee_planner=True), 2,
                                          rng=np.random.default_rng(1), max_steps=5, beta=0.3)
    assert port[1:] == ref[1:] and len(port[0]) == len(ref[0]) == 2
    for i, (p, r) in enumerate(zip(port[0], ref[0])):
        assert p["rgb"].shape[1:] == (180, 320, 3)
        hold_dagger_episode(p, r, f"episode {i}")
    with pytest.raises(ValueError, match="rng"):
        dagger.collect_dagger_episode(port_env, ConstantPolicy(),
                                      RRTPushOracle(port_env, use_ee_planner=True), beta=0.5)


def _fake_episode(k, t=3):
    return {
        "action": np.full((t, 2), 0.01 * k, np.float32),
        "is_first": np.arange(t) == 0,
        "is_terminal": np.arange(t) == t - 1,
        "rgb": np.full((t, 4, 6, 3), k, np.uint8),
        "instruction": np.full((t, 512), k, np.float32),
        "instruction_text": np.frombuffer(b"push it", np.uint8).copy(),
    }


def _corpus(root, writer):
    os.makedirs(os.path.join(root, "train"))
    for i in range(2):
        with open(os.path.join(root, "train", f"episode_{i}.npz"), "wb") as f:
            f.write(b"x")
    writer(root, episodes=2, embedder="hash", seed=0, reward="block2block")
    # A crashed aggregation's orphan and stage directory.
    with open(os.path.join(root, "train", "episode_2.npz"), "wb") as f:
        f.write(b"x")
    os.makedirs(os.path.join(root, "train", ".dagger_stage.dead"))


def test_append_episodes_to_corpus_matches_jax(tmp_path):
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    _corpus(port_dir, write_manifest)
    _corpus(ref_dir, jax_collect.write_manifest)
    for batch in ([_fake_episode(1), _fake_episode(2)], [_fake_episode(3)], []):
        assert dagger.append_episodes_to_corpus(port_dir, batch) == \
            jax_dagger.append_episodes_to_corpus(ref_dir, batch)
        with open(os.path.join(port_dir, "manifest.json"), "rb") as f, \
                open(os.path.join(ref_dir, "manifest.json"), "rb") as g:
            assert f.read() == g.read()
    assert sorted(os.listdir(os.path.join(port_dir, "train"))) == \
        sorted(os.listdir(os.path.join(ref_dir, "train")))
    for name in ("episode_3.npz", "episode_4.npz", "episode_5.npz"):
        port = load_episode(os.path.join(port_dir, "train", name))
        ref = load_episode(os.path.join(ref_dir, "train", name))
        assert sorted(port) == sorted(ref)
        for key in ref:
            assert port[key].tobytes() == ref[key].tobytes(), (name, key)
    with open(os.path.join(port_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert (manifest["episodes"], manifest["collected_episodes"],
            manifest["dagger_episodes"]) == (6, 2, 4)
    for append in (dagger.append_episodes_to_corpus, jax_dagger.append_episodes_to_corpus):
        os.makedirs(tmp_path / "bare" / "train", exist_ok=True)
        with pytest.raises(FileNotFoundError, match="manifest"):
            append(str(tmp_path / "bare"), [])


class Recorder:
    """Fake collect/train endpoints that can crash at a chosen call."""

    def __init__(self, crash_train_at=None, crash_collect_at=None):
        self.collects, self.trains = [], []
        self.crash_train_at, self.crash_collect_at = crash_train_at, crash_collect_at

    def collect_round(self, rnd):
        if self.crash_collect_at == len(self.collects):
            raise RuntimeError("simulated reset during collection")
        self.collects.append(rnd)
        return {"rollout_episodes": 4, "rollout_successes": rnd}

    def train_to(self, target):
        if self.crash_train_at == len(self.trains):
            raise RuntimeError("simulated reset during training")
        self.trains.append(target)


def _run(loop, state_path, rec, base=1000, rounds=3):
    return loop.run_dagger_loop(state_path, base_step=base,
                                config=loop.DaggerLoopConfig(rounds=rounds, extra_steps=500),
                                collect_round=rec.collect_round, train_to=rec.train_to,
                                log=lambda *_: None)


def test_round_target_step_matches_jax():
    for args in ((20000, 0, 2500), (20000, 3, 2500), (0, 1, 7)):
        assert dagger_loop.round_target_step(*args) == jax_loop.round_target_step(*args)


@pytest.mark.parametrize("crash", [None, ("train", 0), ("train", 2), ("collect", 1)],
                         ids=["fresh", "train_0", "train_2", "collect_1"])
def test_dagger_loop_crash_and_resume_matches_jax(tmp_path, crash):
    """Each package runs to a crash (or to the end) and resumes with a fresh
    recorder: the rounds collected, the targets trained and the history
    equal, every round collected once."""
    results = {}
    for name, loop in (("port", dagger_loop), ("ref", jax_loop)):
        state_path = str(tmp_path / f"{name}_state.json")
        first = Recorder(**({f"crash_{crash[0]}_at": crash[1]} if crash else {}))
        if crash:
            with pytest.raises(RuntimeError, match="simulated"):
                _run(loop, state_path, first)
            # A resume must keep the base step recorded at first entry.
            second = Recorder()
            history = _run(loop, state_path, second, base=99999)
        else:
            history, second = _run(loop, state_path, first), Recorder()
        with open(state_path) as f:
            state = json.load(f)
        results[name] = (first.collects + second.collects, first.trains + second.trains,
                         history, state)
        loop.clear_state(state_path)
        assert not os.path.exists(state_path)
        loop.clear_state(state_path)  # absent: no error
    assert results["port"] == results["ref"]
    collects, trains, history, state = results["port"]
    assert collects == [0, 1, 2]
    assert trains[-3:] == [1500, 2000, 2500] or trains == [1500, 2000, 2500]
    assert [h["round"] for h in history] == [0, 1, 2]
    assert state["completed_rounds"] == 3 and state["aggregated_round"] is None


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_dagger_state_file_resumes_across_packages(tmp_path, writer, reader):
    loops = {"port": dagger_loop, "jax": jax_loop}
    state_path = str(tmp_path / "dagger_state.json")
    first = Recorder(crash_train_at=1)  # round 1 aggregated, its training lost
    with pytest.raises(RuntimeError, match="simulated"):
        _run(loops[writer], state_path, first)
    second = Recorder()
    history = _run(loops[reader], state_path, second, base=5)
    assert first.collects == [0, 1] and second.collects == [2]
    assert first.trains == [1500] and second.trains == [2000, 2500]
    assert [h["round"] for h in history] == [0, 1, 2]
