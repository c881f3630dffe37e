"""The port's closed-loop eval against the JAX package's, on the CPU.

* Wrappers: the history stack and the instruction embedding exactly equal
  to `rt1_tpu.eval.wrappers`; `rgb_sequence` within 1/255 of the JAX
  package's cv2 resize (the port resizes with its native sampler).
* Policy: `RT1EvalPolicy` against JAX's on `tiny`-sized weights carried
  across by `convert.py`, in float32: actions within 1e-6 and
  `network_state["seq_idx"]` equal over one observation sequence that
  rolls the window.
* Baselines: `evaluate_policy` with the oracle and the random baseline in
  both packages gives equal result dicts, nothing patched.
* Tiny RT-1, step for step: 2 episodes x 5 steps, BLOCK_4, 64x114 frames,
  window 3, in both packages, each env stepped by its own policy: actions
  within 1e-6 (the two decode tokens to actions in different float32
  order); effector positions within 1e-6; rewards, `done`, successes and
  lengths equal; `evaluate_policy`'s dicts equal.
* The CLI on the CPU: `python -m rt1_tpu_torch.eval` on a workdir the
  train CLI wrote reports the trainer's step; an empty workdir raises; a
  manifest embedder that differs raises unless allowed; no card raises
  unless `--device cpu`; `write_videos=True` writes nothing without a
  workdir (as JAX's) and one GIF an episode with one.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rt1_tpu.envs import blocks as jax_blocks
from rt1_tpu.eval import evaluate as jax_evaluate
from rt1_tpu.eval import wrappers as jax_wrappers
from rt1_tpu.eval.policy import RT1EvalPolicy as JaxRT1EvalPolicy
from rt1_tpu.specs import language_table_action_space as jax_action_space
from rt1_tpu.specs import sample_space
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.convert import load_flax_variables
from rt1_tpu_torch.envs import blocks
from rt1_tpu_torch.eval import evaluate, wrappers
from rt1_tpu_torch.eval.main import main as eval_main
from rt1_tpu_torch.eval.policy import RT1EvalPolicy
from rt1_tpu_torch.eval.restore import build_policy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTION_TOL = 1e-6
RGB_TOL = 1.0 / 255 + 1e-7

torch.set_num_threads(2)


def _tiny_pair(seed, h, w):
    """A JAX `tiny` RT-1 (the Pallas kernel in interpret mode) with seeded
    random float32 variables, and the port's on the same weights (fused
    path, its plain version on the CPU)."""
    jcfg = jax_tiny.get_config()
    jm = jax_build_model(jcfg.model).clone(attention_impl="pallas", pallas_interpret=True)
    t = jcfg.model.time_sequence_length
    obs = {"image": np.zeros((1, t, h, w, 3), np.float32),
           "natural_language_embedding": np.zeros((1, t, 512), np.float32)}
    key = jax.random.PRNGKey(0)
    actions = sample_space(jax_action_space(), key, (1, t))
    shapes = jax.eval_shape(lambda k: jm.init({"params": k, "crop": k}, obs, actions), key)
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32), shapes)
    policy = build_policy(get_config("tiny"), attention_impl="fused")
    load_flax_variables(policy, variables["params"])
    return jm, variables, policy


def _env_pair(**kwargs):
    kwargs = dict(reward_name="block2block", seed=3, target_height=64, target_width=114,
                  sequence_length=3, **kwargs)
    port = evaluate.build_eval_env(block_mode=blocks.BlockMode.BLOCK_4, **kwargs)
    ref = jax_evaluate.build_eval_env(block_mode=jax_blocks.BlockMode.BLOCK_4, **kwargs)
    return port, ref


def _hold_obs(port, ref, what, atol=0.0):
    """`rgb_sequence` within 1/255; the rest bitwise, or within `atol`
    where the two envs were stepped with their own policies' actions."""
    assert sorted(port) == sorted(ref), what
    for key in ref:
        assert port[key].dtype == ref[key].dtype and port[key].shape == ref[key].shape, (what, key)
        if key == "rgb_sequence":
            np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=RGB_TOL,
                                       err_msg=f"{what} {key}")
        elif atol:
            np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=atol,
                                       err_msg=f"{what} {key}")
        else:
            assert port[key].tobytes() == ref[key].tobytes(), (what, key)


def test_wrapped_env_matches_jax():
    port, ref = _env_pair()
    rng = np.random.default_rng(0)
    for episode in range(2):
        _hold_obs(port.reset(), ref.reset(), f"reset {episode}")
        for t in range(5):
            action = rng.uniform(-0.03, 0.03, 2).astype(np.float32)
            p_obs, p_reward, p_done, _ = port.step(action)
            r_obs, r_reward, r_done, _ = ref.step(action)
            _hold_obs(p_obs, r_obs, f"episode {episode} step {t}")
            assert (p_reward, p_done) == (r_reward, r_done)


@pytest.mark.parametrize("geometry", [(180, 320, 256, 456, 0.95), (180, 320, 64, 114, 0.95),
                                      (180, 320, 32, 56, None)])
def test_central_crop_within_one_level_of_cv2(geometry):
    h, w, out_h, out_w, factor = geometry
    rng = np.random.default_rng(1)
    port = wrappers.CentralCropImageWrapper(None, out_h, out_w, factor)
    ref = jax_wrappers.CentralCropImageWrapper(None, out_h, out_w, factor)
    for _ in range(3):
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = port._process({"rgb": frame})["rgb_sequence"]
        want = ref._process({"rgb": frame})["rgb_sequence"]
        assert got.dtype == np.float32 and got.shape == (out_h, out_w, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=RGB_TOL)


def test_eval_policy_matches_jax():
    h, w = 32, 56
    jm, variables, policy = _tiny_pair(seed=9, h=h, w=w)
    port = RT1EvalPolicy(policy)
    ref = JaxRT1EvalPolicy(jm, variables)
    assert (port.action_mean, port.action_std, port.action_minimum, port.action_maximum) == \
        (ref.action_mean, ref.action_std, ref.action_minimum, ref.action_maximum)
    rng = np.random.default_rng(4)
    t = jm.time_sequence_length
    for episode in range(2):
        port.reset()
        ref.reset()
        assert int(port.network_state["seq_idx"]) == int(ref.network_state["seq_idx"]) == 0
        emb = np.tile(rng.standard_normal(512).astype(np.float32), (t, 1))
        for step in range(t + 3):
            obs = {"rgb_sequence": rng.uniform(0, 1, (t, h, w, 3)).astype(np.float32),
                   "natural_language_embedding": emb}
            got, want = port.action(obs), np.asarray(ref.action(obs))
            assert got.dtype == np.float32 and got.shape == (2,)
            np.testing.assert_allclose(got, want, rtol=0, atol=ACTION_TOL,
                                       err_msg=f"episode {episode} step {step}")
            assert int(port.network_state["seq_idx"]) == int(ref.network_state["seq_idx"])


@pytest.mark.parametrize("baseline", ["oracle", "random"])
def test_baselines_match_jax(baseline):
    kwargs = dict(reward_names=("block2block", "block2absolutelocation"),
                  num_evals_per_reward=2, max_episode_steps=30, seed=5,
                  env_kwargs=dict(target_height=32, target_width=56, sequence_length=3))
    if baseline == "oracle":
        port_policy, ref_policy = evaluate.OracleEvalPolicy(seed=5), \
            jax_evaluate.OracleEvalPolicy(seed=5)
    else:
        port_policy, ref_policy = evaluate.RandomEvalPolicy(seed=5), \
            jax_evaluate.RandomEvalPolicy(seed=5)
    got = evaluate.evaluate_policy(port_policy, block_mode=blocks.BlockMode.BLOCK_4, **kwargs)
    want = jax_evaluate.evaluate_policy(ref_policy, block_mode=jax_blocks.BlockMode.BLOCK_4,
                                        **kwargs)
    assert got == want
    assert got["episodes_per_reward"] == 2
    assert sorted(got["mean_episode_length"]) == ["block2absolutelocation", "block2block"]


def _cv2_crop_resize_batch(frames, boxes, out_h, out_w):
    """The JAX wrapper's resize (cv2 INTER_LINEAR), in the port's call form."""
    import cv2

    return np.stack([cv2.resize(f[top:top + ch, left:left + cw], (out_w, out_h),
                                interpolation=cv2.INTER_LINEAR)
                     for f, (top, left, ch, cw) in zip(frames, boxes)])


def test_tiny_rt1_episodes_match_jax_step_for_step(monkeypatch):
    # The renderer is pixel-exact (tests/test_torch_envs_render.py), but the
    # port resizes with its native sampler, within 1 LSB of cv2
    # (test_central_crop_within_one_level_of_cv2). So that both policies see
    # the same frames, and only here, the port's wrapper resizes with cv2.
    monkeypatch.setattr(wrappers, "crop_resize_batch", _cv2_crop_resize_batch)
    h, w = 64, 114
    jm, variables, policy = _tiny_pair(seed=13, h=h, w=w)
    port_policy, ref_policy = RT1EvalPolicy(policy), JaxRT1EvalPolicy(jm, variables)
    port_env, ref_env = _env_pair()
    steps_taken = 0
    for episode in range(2):
        port_policy.reset()
        ref_policy.reset()
        p_obs = evaluate.validated_reset(port_env)
        # The JAX package's run_episode: validate the init with the oracle.
        oracle = jax_evaluate.RRTPushOracle(ref_env, use_ee_planner=True)
        while True:
            r_obs = ref_env.reset()
            if oracle.get_plan(ref_env.compute_state()):
                break
        _hold_obs(p_obs, r_obs, f"episode {episode} reset", atol=ACTION_TOL)
        for step in range(5):
            p_action = port_policy.action(p_obs)
            r_action = np.asarray(ref_policy.action(r_obs))
            np.testing.assert_allclose(p_action, r_action, rtol=0, atol=ACTION_TOL,
                                       err_msg=f"episode {episode} step {step}")
            assert int(port_policy.network_state["seq_idx"]) == \
                int(ref_policy.network_state["seq_idx"])
            p_obs, p_reward, p_done, _ = port_env.step(p_action)
            r_obs, r_reward, r_done, _ = ref_env.step(r_action)
            _hold_obs(p_obs, r_obs, f"episode {episode} step {step}", atol=ACTION_TOL)
            assert (p_reward, p_done) == (r_reward, r_done)
            steps_taken += 1
            if p_done:
                break
        assert port_env.succeeded == ref_env.succeeded
    assert steps_taken >= 2
    kwargs = dict(num_evals_per_reward=2, max_episode_steps=5, seed=3,
                  env_kwargs=dict(target_height=h, target_width=w, sequence_length=3))
    got = evaluate.evaluate_policy(RT1EvalPolicy(policy), block_mode=blocks.BlockMode.BLOCK_4,
                                   **kwargs)
    want = jax_evaluate.evaluate_policy(JaxRT1EvalPolicy(jm, variables),
                                        block_mode=jax_blocks.BlockMode.BLOCK_4, **kwargs)
    assert got == want


def test_write_videos_raises(tmp_path):
    """Videos no longer raise: without a workdir nothing is written, as in
    JAX; with one, a GIF an episode (tests/test_torch_eval_extras.py holds
    their frames and names to JAX's)."""
    kwargs = dict(num_evals_per_reward=1, max_episode_steps=2, write_videos=True,
                  block_mode=blocks.BlockMode.BLOCK_4)
    evaluate.evaluate_policy(evaluate.RandomEvalPolicy(), **kwargs)
    evaluate.evaluate_policy(evaluate.RandomEvalPolicy(), workdir=str(tmp_path), **kwargs)
    (name,) = os.listdir(tmp_path / "videos")
    assert name.startswith("block2block_0_") and name.endswith(".gif")


@pytest.fixture(scope="module")
def trained_workdir(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("eval_cli"))
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-m", "rt1_tpu_torch.train", "--config", "tiny",
                    "--workdir", workdir, "--device", "cpu", "--set", "num_steps=2"],
                   cwd=REPO, env=env, check=True, capture_output=True, text=True, timeout=300)
    return workdir


def test_eval_cli_reports_the_trainers_step(trained_workdir):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "rt1_tpu_torch.eval", "--config", "tiny", "--workdir",
         trained_workdir, "--device", "cpu", "--episodes", "1", "--max_steps", "3",
         "--block_mode", "BLOCK_4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(result) == {"successes", "episodes_per_reward", "mean_episode_length",
                           "checkpoint_step"}
    assert result["checkpoint_step"] == 2 and result["episodes_per_reward"] == 1
    assert result["successes"] == {"block2block": 0} or result["successes"] == {"block2block": 1}
    assert 1 <= result["mean_episode_length"]["block2block"] <= 3


def test_eval_cli_refusals(trained_workdir, tmp_path, capsys, monkeypatch):
    base = ["--config", "tiny", "--episodes", "1", "--max_steps", "1", "--block_mode", "BLOCK_4"]
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        eval_main(base + ["--workdir", str(tmp_path), "--device", "cpu"])
    with open(os.path.join(trained_workdir, "data_manifest.json"), "w") as f:
        json.dump({"embedder": "ngram"}, f)
    try:
        with pytest.raises(ValueError, match="Embedder mismatch"):
            eval_main(base + ["--workdir", trained_workdir, "--device", "cpu"])
        assert eval_main(base + ["--workdir", trained_workdir, "--device", "cpu",
                                 "--allow_embedder_mismatch"]) == 0
        assert json.loads(capsys.readouterr().out.splitlines()[-1])["checkpoint_step"] == 2
        assert eval_main(base + ["--workdir", trained_workdir, "--device", "cpu",
                                 "--embedder", "ngram"]) == 0
        capsys.readouterr()
    finally:
        os.remove(os.path.join(trained_workdir, "data_manifest.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_main(base + ["--workdir", trained_workdir])
