"""RLDS -> episode store conversion, offline and one-shot (counterpart of
`rt1_tpu/data/convert_rlds.py`).

Iterate a TFDS RLDS dataset (Language-Table's
`language_table_blocktoblock_sim`), turn each episode's steps into arrays
(`action`, `is_first`, `is_terminal`, `rgb`, `instruction`), replace the
byte-encoded instruction with its embedding (once an episode; the text is
kept as `instruction_text`), and write `episode_{i}.npz` files split
7800 / 100 / 100 into `train`, `val` and `test`, as the JAX package does.
The dataset is read by the port's own TFDS reader (`data/tfds.py`), so
neither TensorFlow nor `tensorflow_datasets` is needed. The output's
`manifest.json` records the embedder, which the trainer and the eval CLI
hold a run's embedder to (`episodes.check_embedder_compatibility`).

Run:
  python -m rt1_tpu_torch.data.convert_rlds --dataset_dir /path/to/rlds/0.0.1 \\
      --output_dir /data/language_table_npz --embedder hash
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

from rt1_tpu_torch.data import tfds
from rt1_tpu_torch.data.episodes import encode_instruction_text, save_episode, write_manifest

SPLITS = ("train", "val", "test")


def decode_instruction_bytes(bytes_array: np.ndarray) -> str:
    """Strip the zero padding and utf-8 decode (reference `decode_inst`)."""
    arr = np.asarray(bytes_array)
    non_zero = arr[arr != 0]
    if non_zero.shape[0] == 0:
        return ""
    return bytes(non_zero.astype(np.uint8).tolist()).decode("utf-8")


def episode_from_rlds(rlds_episode, embed_fn) -> Optional[dict]:
    """One RLDS episode (its `steps` iterable by `as_numpy_iterator()`) ->
    the episode dict, or None for an episode without steps."""
    actions, firsts, terminals, rgbs, embeds = [], [], [], [], []
    cached_embedding = None
    text = ""
    for step in rlds_episode["steps"].as_numpy_iterator():
        obs = step["observation"]
        if cached_embedding is None:
            # One instruction an episode: embed it once, at the step whose
            # text is stored, so the two never diverge.
            text = decode_instruction_bytes(obs["instruction"])
            cached_embedding = np.asarray(embed_fn(text), np.float32)
        actions.append(np.asarray(step["action"], np.float32))
        firsts.append(bool(step["is_first"]))
        terminals.append(bool(step["is_terminal"]))
        rgbs.append(np.asarray(obs["rgb"], np.uint8))
        embeds.append(cached_embedding)
    if not actions:
        return None
    return {
        "action": np.stack(actions),
        "is_first": np.array(firsts),
        "is_terminal": np.array(terminals),
        "rgb": np.stack(rgbs),
        "instruction": np.stack(embeds),
        "instruction_text": encode_instruction_text(text),
    }


def convert(dataset_dir: str, output_dir: str, embedder="hash", num_train: int = 7800,
            num_val: int = 100, num_test: int = 100, progress_every: int = 100) -> int:
    """Convert the first num_train + num_val + num_test episodes of the
    dataset's `train` split into `<output_dir>/{train,val,test}/`; returns
    the episodes written."""
    from rt1_tpu_torch.eval.embedding import get_embedder

    embed_fn = get_embedder(embedder)
    builder = tfds.TfdsDirectory(dataset_dir)
    total = num_train + num_val + num_test
    quotas = (("train", num_train), ("val", num_val), ("test", num_test))
    for name, _ in quotas:
        os.makedirs(os.path.join(output_dir, name), exist_ok=True)
    split_iter = iter(quotas)
    split_name, split_quota = next(split_iter)
    split_count = written = 0
    counts = {name: 0 for name in SPLITS}
    for rlds_episode in builder.episodes(f"train[:{total}]"):
        ep = episode_from_rlds(rlds_episode, embed_fn)
        if ep is None:
            continue
        while split_count >= split_quota:
            split_name, split_quota = next(split_iter)
            split_count = 0
        save_episode(os.path.join(output_dir, split_name, f"episode_{split_count}.npz"), ep)
        split_count += 1
        counts[split_name] += 1
        written += 1
        if progress_every and written % progress_every == 0:
            print(f"converted {written}/{total}", flush=True)
    write_manifest(output_dir, embedder=embedder, source="rlds",
                   dataset=builder.name, dataset_dir=os.path.abspath(dataset_dir),
                   episodes=written, splits=counts)
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset_dir", required=True, help="TFDS RLDS dataset directory.")
    parser.add_argument("--output_dir", required=True, help="Episode-store output dir.")
    parser.add_argument("--embedder", default="hash", help="Instruction embedder spec.")
    parser.add_argument("--num_train", type=int, default=7800, help="Train episodes.")
    parser.add_argument("--num_val", type=int, default=100, help="Val episodes.")
    parser.add_argument("--num_test", type=int, default=100, help="Test episodes.")
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    n = convert(args.dataset_dir, args.output_dir, embedder=args.embedder,
                num_train=args.num_train, num_val=args.num_val, num_test=args.num_test)
    print(f"done: {n} episodes in {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
