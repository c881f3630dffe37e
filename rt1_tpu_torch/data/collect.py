"""Demonstration data from the scripted RRT push oracle (counterpart of
`rt1_tpu/data/collect.py`).

Rolls `RRTPushOracle` out on the port's simulator and writes successful
episodes in the episode format of `episodes.py` (action, is_first,
is_terminal, rgb, instruction embedding per step, plus the instruction
text and the task id), so a corpus is made in-repo at any scale. DART
(`exec_noise_std` > 0): the executed action is the oracle's plus Gaussian
noise, the recorded label the oracle's clean action for the state reached.

Where the JAX package resizes frames with `cv2.resize` (`image_hw`), the
port uses its native window sampler (`native.crop_resize_batch`, cv2's
INTER_LINEAR convention, within 1/255 of it) over the full frame.

`collect_dataset_parallel` fans the work out over worker processes started
by `forkserver`: each forks from a fresh server process, never from a
parent that may already hold a CUDA context (fork is unsafe there), and
starts faster than `spawn`, which also aborts torch when a worker is shut
down mid-batch (the data loader's finding, `pipeline.py`). Each worker
writes a private shard directory with its own seed (`seed + w`); the parent
shuffles the shard files and deals them into the splits, as the JAX
package does, so one seed gives the same files in both packages.

Run:
  python -m rt1_tpu_torch.data.collect --data_dir /tmp/lt_data --episodes 100
"""

from __future__ import annotations

import argparse
import functools
import os
import shutil
import sys

import numpy as np

from rt1_tpu_torch.data.episodes import encode_instruction_text, read_manifest, save_episode, \
    write_manifest
from rt1_tpu_torch.data.native import crop_resize_batch
from rt1_tpu_torch.data.pack import UNKNOWN_TASK
from rt1_tpu_torch.envs import LanguageTable, blocks
from rt1_tpu_torch.envs import rewards as rewards_module
from rt1_tpu_torch.envs.oracles import RRTPushOracle
from rt1_tpu_torch.eval.embedding import get_embedder

SPLITS = (("train", 0.975), ("val", 0.0125), ("test", 0.0125))


def canonical_task_id(reward_name) -> str:
    """The task id stamped into episodes: a reward family name passes
    through, any other name becomes `"unknown:<name>"`, and an empty one
    `"unknown"`."""
    if not reward_name:
        return UNKNOWN_TASK
    name = str(reward_name)
    if name in rewards_module.REWARD_FAMILIES:
        return name
    return f"{UNKNOWN_TASK}:{name}"


def resize_frames(frames, image_hw) -> np.ndarray:
    """(T, H, W, 3) uint8 frames -> (T, h, w, 3) with the native sampler
    over the whole frame (the port's `cv2.resize(..., INTER_LINEAR)`)."""
    frames = list(frames)
    h, w = frames[0].shape[:2]
    boxes = np.tile(np.asarray([[0, 0, h, w]], np.int32), (len(frames), 1))
    return crop_resize_batch(frames, boxes, int(image_hw[0]), int(image_hw[1]))


def collect_episode(env, oracle, embedder, max_steps=80, image_hw=None, exec_noise_std=0.0,
                    noise_rng=None, task=None):
    """One oracle rollout -> episode dict, or None if the init has no plan
    or the oracle did not finish within `max_steps`.

    With `exec_noise_std` > 0 (DART, Laskey et al. 2017) the executed action
    is the oracle's plus N(0, std) noise drawn from `noise_rng`, and the
    recorded label stays the oracle's clean action for the state reached.
    """
    if exec_noise_std and noise_rng is None:
        raise ValueError("exec_noise_std > 0 requires a noise_rng")
    obs = env.reset()
    oracle.reset()
    if not oracle.get_plan(env.compute_state()):
        return None
    embedding = np.asarray(embedder(env.instruction_str), np.float32)
    steps = {"action": [], "is_first": [], "is_terminal": [], "rgb": [], "instruction": []}
    done = False
    t = 0
    while not done and t < max_steps:
        rgb = obs["rgb"]
        action = oracle.action(env.compute_state())
        exec_action = action
        if exec_noise_std:
            action = np.asarray(action, np.float32)
            exec_action = action + noise_rng.normal(
                0.0, exec_noise_std, size=action.shape).astype(np.float32)
        obs, _, done, _ = env.step(exec_action)
        steps["action"].append(np.asarray(action, np.float32))
        steps["is_first"].append(t == 0)
        steps["is_terminal"].append(bool(done))
        steps["rgb"].append(np.array(rgb, np.uint8))
        steps["instruction"].append(embedding)
        t += 1
    if not done:
        return None  # the oracle failed; unsuccessful demos are dropped
    episode = {k: np.stack(v) for k, v in steps.items()}
    if image_hw is not None:
        episode["rgb"] = resize_frames(episode["rgb"], image_hw)
    episode["instruction_text"] = encode_instruction_text(env.instruction_str)
    if task:
        episode["task"] = encode_instruction_text(task)
    return episode


def _make_collector(block_mode, reward_name, seed, embedder):
    """(env, oracle, embed_fn, noise_rng) of one collecting process."""
    env = LanguageTable(block_mode=block_mode,
                        reward_factory=rewards_module.get_reward_factory(reward_name), seed=seed)
    oracle = RRTPushOracle(env, use_ee_planner=True, seed=seed)
    return env, oracle, get_embedder(embedder), np.random.default_rng(seed + 7919)


def collect_dataset(data_dir, num_episodes, block_mode=blocks.BlockMode.BLOCK_8,
                    reward_name="block2block", seed=0, max_steps=80, splits=SPLITS,
                    embedder="hash", image_hw=None, progress_every=25, exec_noise_std=0.0,
                    stats=None):
    """Collect `num_episodes` successful demos into split directories (the
    reference's 7800/100/100 proportions by default), filled in order, and
    stamp the manifest. Returns the count per split; `stats`, a dict if
    given, receives the `attempts`."""
    env, oracle, embed_fn, noise_rng = _make_collector(block_mode, reward_name, seed, embedder)
    counts = {name: 0 for name, _ in splits}
    quotas = _split_quotas(splits, num_episodes)
    for name, _ in splits:
        os.makedirs(os.path.join(data_dir, name), exist_ok=True)
    collected = attempts = 0
    while collected < num_episodes:
        attempts += 1
        ep = collect_episode(env, oracle, embed_fn, max_steps=max_steps, image_hw=image_hw,
                             exec_noise_std=exec_noise_std, noise_rng=noise_rng,
                             task=canonical_task_id(reward_name))
        if ep is None:
            continue
        for name, _ in splits:  # train first, then val, then test
            if counts[name] < quotas[name]:
                break
        save_episode(os.path.join(data_dir, name, f"episode_{counts[name]}.npz"), ep)
        counts[name] += 1
        collected += 1
        if progress_every and collected % progress_every == 0:
            print(f"collected {collected}/{num_episodes} ({attempts} attempts)", flush=True)
    if stats is not None:
        stats["attempts"] = attempts
    write_manifest(data_dir, embedder=embedder, reward=reward_name, block_mode=block_mode.value,
                   max_steps=max_steps, image_hw=image_hw, episodes=num_episodes, seed=seed,
                   exec_noise_std=exec_noise_std)
    return counts


def _split_quotas(splits, num_episodes):
    """Episode quota per split; the rounding drift goes to the first."""
    quotas = {name: int(round(frac * num_episodes)) for name, frac in splits}
    quotas[splits[0][0]] += num_episodes - sum(quotas.values())
    return quotas


def _collect_shard(shard_dir, count, seed, kwargs):
    """One worker: collect `count` successful episodes into `shard_dir`;
    returns the attempts it took."""
    reward_name = kwargs.get("reward_name", "block2block")
    env, oracle, embed_fn, noise_rng = _make_collector(
        blocks.BlockMode(kwargs.get("block_mode", "BLOCK_8")), reward_name, seed,
        kwargs.get("embedder", "hash"))
    os.makedirs(shard_dir, exist_ok=True)
    done = attempts = 0
    while done < count:
        attempts += 1
        ep = collect_episode(env, oracle, embed_fn, max_steps=kwargs.get("max_steps", 80),
                             image_hw=kwargs.get("image_hw"),
                             exec_noise_std=kwargs.get("exec_noise_std", 0.0),
                             noise_rng=noise_rng, task=canonical_task_id(reward_name))
        if ep is None:
            continue
        save_episode(os.path.join(shard_dir, f"episode_{done}.npz"), ep)
        done += 1
    return attempts


def _shard_worker(shard_dir, count, seed, kwargs):
    """A worker process's body: collect, then record the attempts beside
    the shard (`attempts.txt`), for the parent's accounting."""
    attempts = _collect_shard(shard_dir, count, seed, kwargs)
    with open(os.path.join(shard_dir, "attempts.txt"), "w") as f:
        f.write(str(attempts))


def _shard_episodes(shard_root):
    return sorted(os.path.join(root, f) for root, _, files in os.walk(shard_root)
                  for f in files if f.endswith(".npz"))


def collect_dataset_parallel(data_dir, num_episodes, workers=8,
                             block_mode=blocks.BlockMode.BLOCK_8, reward_name="block2block",
                             seed=0, max_steps=80, splits=SPLITS, embedder="hash",
                             image_hw=None, exec_noise_std=0.0, stats=None):
    """`collect_dataset` over `workers` processes (`forkserver`), worker `w`
    seeded at `seed + w` into its own shard; the parent deals the shards
    into the splits and stamps the manifest. Returns the count per split;
    `stats`, a dict if given, receives the workers' `attempts`."""
    import multiprocessing as mp

    per = [num_episodes // workers] * workers
    for i in range(num_episodes % workers):
        per[i] += 1
    kwargs = dict(block_mode=block_mode.value, reward_name=reward_name, embedder=embedder,
                  max_steps=max_steps, image_hw=image_hw, exec_noise_std=exec_noise_std)
    shard_root = os.path.join(data_dir, "_shards")
    # A crashed earlier run's shard files would be dealt into this corpus.
    shutil.rmtree(shard_root, ignore_errors=True)
    ctx = mp.get_context("forkserver")
    procs = []
    for w, count in enumerate(per):
        if count == 0:
            continue
        p = ctx.Process(target=_shard_worker,
                        args=(os.path.join(shard_root, f"shard_{w}"), count, seed + w, kwargs))
        p.start()
        procs.append(p)
    try:
        for p in procs:
            p.join()
            if p.exitcode != 0:
                raise RuntimeError(f"collect worker failed (exit {p.exitcode})")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    if stats is not None:
        attempts = 0
        for name in os.listdir(shard_root):
            with open(os.path.join(shard_root, name, "attempts.txt")) as f:
                attempts += int(f.read())
        stats["attempts"] = attempts
    all_eps = _shard_episodes(shard_root)
    if len(all_eps) < num_episodes:
        raise RuntimeError(f"workers produced {len(all_eps)} episodes, need {num_episodes}")
    return _deal_shards(data_dir, shard_root, all_eps[:num_episodes], splits, seed,
                        embedder=embedder, reward=reward_name, block_mode=block_mode.value,
                        max_steps=max_steps, image_hw=image_hw, workers=workers,
                        exec_noise_std=exec_noise_std)


def _deal_shards(data_dir, shard_root, all_eps, splits, seed, **manifest_fields):
    """Shuffle the shard episodes (`default_rng(seed)`), deal them into the
    split directories, remove the shards and stamp the manifest."""
    quotas = _split_quotas(splits, len(all_eps))
    counts = {name: 0 for name, _ in splits}
    order = []
    for name, _ in splits:
        order.extend([name] * quotas[name])
    rng = np.random.default_rng(seed)
    all_eps = list(all_eps)
    rng.shuffle(all_eps)
    for path, name in zip(all_eps, order):
        dst = os.path.join(data_dir, name)
        os.makedirs(dst, exist_ok=True)
        shutil.move(path, os.path.join(dst, f"episode_{counts[name]}.npz"))
        counts[name] += 1
    shutil.rmtree(shard_root, ignore_errors=True)
    write_manifest(data_dir, episodes=len(all_eps), seed=seed, **manifest_fields)
    return counts


def finalize_shards(data_dir, splits=SPLITS, seed=0, **manifest_fields):
    """Deal whatever intact episodes `_shards/` holds into the splits and
    stamp a manifest: the salvage of a parallel collection stopped early.
    The caller passes the manifest fields the collection was launched with
    (shard files do not record them). Refuses when a split already holds
    episodes; skips shard files that do not open (a worker killed inside
    `np.savez`)."""
    shard_root = os.path.join(data_dir, "_shards")
    for name, _ in splits:
        split_dir = os.path.join(data_dir, name)
        if os.path.isdir(split_dir) and os.listdir(split_dir):
            raise RuntimeError(
                f"refusing to finalize: {split_dir} already has episodes (a prior deal?); "
                "dealing would renumber from episode_0 and mix two corpora under one manifest.")
    all_eps = []
    for path in _shard_episodes(shard_root):
        try:
            with np.load(path) as z:
                z.files  # noqa: B018 (parses the zip directory)
            all_eps.append(path)
        except Exception as e:  # noqa: BLE001 (any unreadable file is skipped)
            print(f"finalize: skipping corrupt shard file {path}: {e!r}")
    if not all_eps:
        raise RuntimeError(f"no intact shard episodes under {shard_root}")
    return _deal_shards(data_dir, shard_root, all_eps, splits, seed, **manifest_fields)


def corpus_accounting(data_dir, manifest=None):
    """(episodes collected, episodes per split) from the manifest and the
    files on disk, never from flags: the manifest's total where there is
    one, else the files counted."""
    if manifest is None:
        manifest = read_manifest(data_dir)
    split_counts = {
        name: sum(1 for f in os.listdir(os.path.join(data_dir, name)) if f.endswith(".npz"))
        for name in ("train", "val", "test") if os.path.isdir(os.path.join(data_dir, name))
    }
    disk_total = sum(split_counts.values())
    episodes = manifest.get("episodes", disk_total) if manifest is not None else disk_total
    return episodes, split_counts


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.data.collect",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", default="/tmp/lt_data", help="Output directory.")
    p.add_argument("--episodes", type=int, default=100, help="Successful episodes to collect.")
    p.add_argument("--block_mode", default="BLOCK_8", help="Block variant.")
    p.add_argument("--reward", default="block2block", help="Reward family.")
    p.add_argument("--seed", type=int, default=0, help="Env seed.")
    p.add_argument("--max_steps", type=int, default=80, help="Max steps per episode.")
    p.add_argument("--embedder", default="hash", help="Instruction embedder spec.")
    p.add_argument("--workers", type=int, default=1, help="Parallel collection processes.")
    p.add_argument("--exec_noise_std", type=float, default=0.0,
                   help="DART execution-noise std: executed action = oracle action + N(0, std); "
                        "the recorded label stays clean.")
    p.add_argument("--finalize_shards", action="store_true",
                   help="Deal an interrupted parallel collection's _shards/ into split dirs + "
                        "manifest instead of collecting; pass the flags it was launched with.")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.finalize_shards:
        counts = finalize_shards(
            args.data_dir, seed=args.seed, embedder=args.embedder, reward=args.reward,
            block_mode=blocks.BlockMode(args.block_mode).value, max_steps=args.max_steps,
            image_hw=None, workers=args.workers, exec_noise_std=args.exec_noise_std)
        print("finalized:", counts)
        return 0
    collect = collect_dataset if args.workers <= 1 else functools.partial(
        collect_dataset_parallel, workers=args.workers)
    counts = collect(args.data_dir, args.episodes, block_mode=blocks.BlockMode(args.block_mode),
                     reward_name=args.reward, seed=args.seed, max_steps=args.max_steps,
                     embedder=args.embedder, exec_noise_std=args.exec_noise_std)
    print("done:", counts)
    return 0


if __name__ == "__main__":
    # Through the package module, so the workers unpickle their target
    # from `rt1_tpu_torch.data.collect` rather than from `__main__`.
    from rt1_tpu_torch.data.collect import main as _main

    sys.exit(_main())
