"""Closed-loop evaluation protocol (counterpart of `rt1_tpu/eval/evaluate.py`).

Parity source: reference `language_table/eval/main_rt1.py:100-221`: per
reward family build the wrapped env chain, validate each episode init by
requiring the RRT oracle to find a plan, roll out up to
`max_episode_steps`, count success via the sparse reward. The same
constants, baselines and result dict as the JAX package. Episode videos
(`write_videos`) are animated GIFs (`eval/video.py`) of the env's frames
under the instruction overlay, in JAX's folders and names.
"""

import collections
import os

import numpy as np

from rt1_tpu_torch.envs import LanguageTable, blocks
from rt1_tpu_torch.envs import rewards as rewards_module
from rt1_tpu_torch.envs.oracles import RRTPushOracle
from rt1_tpu_torch.eval.embedding import get_embedder
from rt1_tpu_torch.eval.wrappers import (
    CentralCropImageWrapper,
    HistoryWrapper,
    InstructionEmbeddingWrapper,
)

# Default protocol constants (reference `main_rt1.py:118-119`).
DEFAULT_REWARDS = ("block2block",)
NUM_EVALS_PER_REWARD = 10
MAX_EPISODE_STEPS = 80


class RandomEvalPolicy:
    """Uniform actions in the eval policy's clip range — the chance
    baseline every learning proof is read against."""

    def __init__(self, seed=0, low=-0.03, high=0.03):
        self._rng = np.random.default_rng(seed)
        self._low, self._high = low, high

    def reset(self):
        pass

    def action(self, observation):
        del observation
        return self._rng.uniform(self._low, self._high, 2).astype("float32")


class OracleEvalPolicy:
    """The scripted RRT expert run under the identical eval protocol: the
    protocol's ceiling, well below 100 % inside the 80-step budget.

    Reads privileged simulator state (`env.compute_state()`), so
    `evaluate_policy` hands it each freshly built env (`bind_env`); the
    oracle plans lazily inside `action` and replans on instruction change.
    """

    def __init__(self, seed=0):
        self._seed = seed
        self._env = None
        self._oracle = None

    def bind_env(self, env):
        self._env = env
        self._oracle = RRTPushOracle(env, use_ee_planner=True, seed=self._seed)

    def reset(self):
        if self._oracle is None:
            raise RuntimeError(
                "OracleEvalPolicy requires evaluate_policy (bind_env) to "
                "attach the env before rollouts."
            )
        self._oracle.reset()

    def action(self, observation):
        del observation  # privileged: reads simulator state directly
        return np.asarray(
            self._oracle.action(self._env.compute_state()), np.float32
        )


def build_eval_env(
    reward_name="block2block",
    block_mode=blocks.BlockMode.BLOCK_8,
    seed=0,
    embedder="hash",
    target_height=256,
    target_width=456,
    random_crop_factor=0.95,
    sequence_length=6,
    backend="kinematic",
    history_keys=None,
):
    """The reference env chain (`main_rt1.py:130-142`), our wrappers.
    `history_keys` overrides the stacked observation keys."""
    env = LanguageTable(
        block_mode=block_mode,
        reward_factory=rewards_module.get_reward_factory(reward_name),
        seed=seed,
        backend=backend,
    )
    env = InstructionEmbeddingWrapper(env, get_embedder(embedder))
    env = CentralCropImageWrapper(
        env,
        target_height=target_height,
        target_width=target_width,
        random_crop_factor=random_crop_factor,
    )
    if history_keys is None:
        history_keys = (
            "rgb_sequence", "natural_language_embedding",
            "effector_translation", "effector_target_translation",
        )
    env = HistoryWrapper(
        env, history_length=sequence_length, keys=tuple(history_keys)
    )
    return env


def validated_reset(env):
    """Reset until the RRT oracle finds a collision-free plan for the
    episode's task (reference `main_rt1.py:163-172`); returns the obs."""
    oracle = RRTPushOracle(env, use_ee_planner=True)
    while True:
        obs = env.reset()
        if oracle.get_plan(env.compute_state()):
            return obs


def run_episode(env, policy, max_episode_steps=MAX_EPISODE_STEPS, collect_frames=False):
    """One oracle-validated episode. Returns (success, steps, frames): the
    rendered frames (the first after the reset, then one a step) when
    `collect_frames`, else an empty list."""
    policy.reset()
    obs = validated_reset(env)
    frames = [env.render()] if collect_frames else []
    done = False
    steps = 0
    while not done and steps < max_episode_steps:
        action = policy.action(obs)
        obs, _, done, _ = env.step(action)
        if collect_frames:
            frames.append(env.render())
        steps += 1
    return bool(env.succeeded), steps, frames


def write_video(path_stem, frames, fps=10):
    """`<path_stem>.gif`, an animated GIF of `frames` (`eval/video.py`):
    where the JAX package writes mp4 when imageio has ffmpeg, the port
    always writes the GIF JAX falls back to. Returns its path."""
    from rt1_tpu_torch.eval.video import write_gif

    return write_gif(path_stem + ".gif", frames, fps=fps)


def evaluate_policy(
    policy,
    workdir=None,
    reward_names=DEFAULT_REWARDS,
    num_evals_per_reward=NUM_EVALS_PER_REWARD,
    max_episode_steps=MAX_EPISODE_STEPS,
    block_mode=blocks.BlockMode.BLOCK_8,
    seed=0,
    embedder="hash",
    write_videos=False,
    env_kwargs=None,
    video_tag="",
):
    """Full protocol over reward families; returns {"successes": {reward:
    count}, "episodes_per_reward", "mean_episode_length": {reward: mean}}.

    With `write_videos` and a `workdir`, each episode (the instruction
    overlay on every frame) goes to
    `<workdir>/videos_<video_tag>/<reward>_<episode>_<success|failure>.gif`
    (`videos` without a tag): the tag keeps two policies evaluated in one
    workdir from overwriting each other's videos."""
    video_dir = None
    if write_videos and workdir is not None:
        video_dir = os.path.join(workdir, f"videos_{video_tag}" if video_tag else "videos")
        os.makedirs(video_dir, exist_ok=True)
    results = collections.defaultdict(int)
    episode_lengths = collections.defaultdict(list)
    for reward_name in reward_names:
        env = build_eval_env(
            reward_name=reward_name,
            block_mode=block_mode,
            seed=seed,
            embedder=embedder,
            **(env_kwargs or {}),
        )
        if hasattr(policy, "bind_env"):  # privileged policies (oracle)
            policy.bind_env(env)
        for ep in range(num_evals_per_reward):
            success, steps, frames = run_episode(
                env, policy, max_episode_steps=max_episode_steps,
                collect_frames=video_dir is not None,
            )
            results[reward_name] += int(success)
            episode_lengths[reward_name].append(steps)
            if video_dir is not None:
                tag = "success" if success else "failure"
                write_video(os.path.join(video_dir, f"{reward_name}_{ep}_{tag}"), frames)
    return {
        "successes": dict(results),
        "episodes_per_reward": num_evals_per_reward,
        "mean_episode_length": {
            k: float(np.mean(v)) for k, v in episode_lengths.items()
        },
    }
