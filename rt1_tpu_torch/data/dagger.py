"""DAgger corrective relabelling: on-policy states, oracle labels
(counterpart of `rt1_tpu/data/dagger.py`).

Roll the trained policy out, have the scripted RRT oracle label every
visited state with its corrective action, aggregate those episodes into
the corpus, retrain, iterate (Ross et al. 2011). DART covers states near
the demos; DAgger covers the states the trained policy actually visits.

Episodes have the format of `collect.collect_episode` (native-resolution
uint8 rgb, per-step instruction embedding, clean oracle labels), so an
aggregated corpus loads through the standard pipeline. Where the JAX
package resizes with `cv2.resize` (`image_hw`), the port uses the native
sampler (`collect.resize_frames`).
"""

from __future__ import annotations

import os
import shutil
import uuid

import numpy as np

from rt1_tpu_torch.data.collect import resize_frames
from rt1_tpu_torch.data.episodes import encode_instruction_text, read_manifest, save_episode, \
    write_manifest

# The policy sees the standard eval observation; the collector also needs
# the native-resolution frame, so the env is built with this history-key
# set (RT1EvalPolicy.action ignores the extra key).
DAGGER_HISTORY_KEYS = (
    "rgb", "rgb_sequence", "natural_language_embedding",
    "effector_translation", "effector_target_translation",
)


def collect_dagger_episode(env, policy, oracle, max_steps=80, beta=0.0, rng=None,
                           image_hw=None):
    """One on-policy rollout with per-step oracle relabelling.

    `env` is the wrapped eval env (`build_eval_env(history_keys=
    DAGGER_HISTORY_KEYS)`). The executed action is the policy's or, with
    probability `beta`, the oracle's; the recorded label is always the
    oracle's action for the state visited. The policy is queried every
    step, so its rolling window matches eval-time execution. Unsuccessful
    episodes are kept, and `is_terminal` is recorded as the env reported it.

    Returns (episode dict | None, succeeded); None when the init has no
    collision-free plan.
    """
    if beta and rng is None:
        raise ValueError("beta > 0 requires an rng")
    obs = env.reset()
    policy.reset()
    oracle.reset()
    if not oracle.get_plan(env.compute_state()):
        return None, False
    steps = {"action": [], "is_first": [], "is_terminal": [], "rgb": [], "instruction": []}
    done = False
    t = 0
    while not done and t < max_steps:
        label = np.asarray(oracle.action(env.compute_state()), np.float32)
        proposed = np.asarray(policy.action(obs), np.float32)
        exec_action = proposed
        if beta and rng.random() < beta:
            exec_action = label
        steps["action"].append(label)
        steps["is_first"].append(t == 0)
        steps["rgb"].append(np.array(obs["rgb"][-1], np.uint8))  # native frame
        steps["instruction"].append(
            np.asarray(obs["natural_language_embedding"][-1], np.float32))
        obs, _, done, _ = env.step(exec_action)
        steps["is_terminal"].append(bool(done))
        t += 1
    episode = {k: np.stack(v) for k, v in steps.items()}
    if image_hw is not None:
        episode["rgb"] = resize_frames(episode["rgb"], image_hw)
    episode["instruction_text"] = encode_instruction_text(env.instruction_str)
    return episode, bool(env.succeeded)


def _count(d):
    return sum(1 for f in os.listdir(d) if f.startswith("episode_") and f.endswith(".npz"))


def _disk_total(data_dir):
    total = 0
    for entry in os.listdir(data_dir):
        sub = os.path.join(data_dir, entry)
        if os.path.isdir(sub) and not entry.startswith((".", "_")):
            total += _count(sub)
    return total


def append_episodes_to_corpus(data_dir, episodes, split="train"):
    """Aggregate DAgger episodes into a corpus split; returns the split's
    episode count after.

    Numbering continues the split's. The episodes are written into a hidden
    stage directory and renamed into the split only when all are written;
    the manifest's `episodes` is then reconciled from the files on disk
    (`collected_episodes` is the collect-time count, stamped on the first
    aggregation; `dagger_episodes` the rest), so files a crashed
    aggregation left behind are counted by the next one. The embedder,
    reward and block-mode stamps are left as they are: callers roll out
    under the corpus's own settings.
    """
    manifest = read_manifest(data_dir)
    if manifest is None:
        raise FileNotFoundError(f"{data_dir} has no manifest.json; aggregate only into corpora "
                                "produced by rt1_tpu_torch.data.collect")
    split_dir = os.path.join(data_dir, split)
    os.makedirs(split_dir, exist_ok=True)
    # Stage directories of a crashed aggregation were never renamed in.
    for entry in os.listdir(split_dir):
        if entry.startswith(".dagger_stage."):
            shutil.rmtree(os.path.join(split_dir, entry), ignore_errors=True)
    baseline = manifest.get("collected_episodes")
    if baseline is None:
        baseline = manifest.get("episodes", 0) - manifest.get("dagger_episodes", 0)
    baseline = min(baseline, _disk_total(data_dir))
    existing = _count(split_dir)
    stage_dir = os.path.join(split_dir, f".dagger_stage.{uuid.uuid4().hex}")
    os.makedirs(stage_dir)
    try:
        names = [f"episode_{existing + i}.npz" for i in range(len(episodes))]
        for name, episode in zip(names, episodes):
            save_episode(os.path.join(stage_dir, name), episode)
        for name in names:
            os.replace(os.path.join(stage_dir, name), os.path.join(split_dir, name))
    finally:
        shutil.rmtree(stage_dir, ignore_errors=True)
    manifest["collected_episodes"] = baseline
    manifest["episodes"] = _disk_total(data_dir)
    manifest["dagger_episodes"] = manifest["episodes"] - baseline
    write_manifest(data_dir, **manifest)
    return existing + len(episodes)


def collect_dagger_batch(env, policy, oracle, num_episodes, rng, max_steps=80, beta=0.0,
                         max_attempts_factor=5):
    """Collect `num_episodes` relabelled on-policy episodes, failures kept;
    inits without a plan are redrawn, within `max_attempts_factor *
    num_episodes` attempts. Returns (episodes, successes, attempts)."""
    episodes, successes, attempts = [], 0, 0
    while len(episodes) < num_episodes and attempts < max_attempts_factor * num_episodes:
        attempts += 1
        ep, success = collect_dagger_episode(env, policy, oracle, max_steps=max_steps, beta=beta,
                                             rng=rng)
        if ep is None:
            continue
        episodes.append(ep)
        successes += int(success)
    return episodes, successes, attempts
