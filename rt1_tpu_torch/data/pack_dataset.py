"""Offline packer: build the packed mmap frame cache of a split
(counterpart of `scripts/pack_dataset.py`, the same flags and the same
pack).

Decodes each episode of `<data_dir>/<split>/episode_*.np*` once and writes
its frames at the packed resolution (`rt1_tpu_torch/data/pack.py`); run it
once per (geometry, split), then train with `--set data.packed_cache=True`:

  python -m rt1_tpu_torch.data.pack_dataset --data_dir /data/lt \\
      --split train --split val --height 256 --width 456 --crop_factor 0.95

Append mode adds new episodes to an existing pack as a new shard (geometry
from its manifest, episodes already packed skipped); a running trainer's
feeder picks the shard up at its next epoch:

  python -m rt1_tpu_torch.data.pack_dataset --append \\
      --out_dir /data/lt/train_packed --episodes_dir /data/new_episodes

Prints one JSON line per split (geometry, episode and frame counts, bytes,
seconds); exits 1 when a split has no episodes or an append fails.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.data.pack_dataset",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", default=None,
                   help="Episode root (holds <split>/episode_*.np*); required unless --append "
                        "with --out_dir.")
    p.add_argument("--append", action="store_true",
                   help="Append new episodes to an existing pack as a new shard; the geometry "
                        "flags are ignored (the manifest's geometry is corpus-wide).")
    p.add_argument("--episodes_dir", default=None,
                   help="With --append: the directory of the new episode_*.np* files "
                        "(default <data_dir>/<split>).")
    p.add_argument("--split", action="append", default=None,
                   help="Split(s) to pack (repeatable); default: train, val.")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=456)
    p.add_argument("--crop_factor", type=str, default="0.95",
                   help="Train-time crop factor, or 'none' for the full frame.")
    p.add_argument("--out_dir", default=None,
                   help="Pack directory (default <data_dir>/<split>_packed); one --split only.")
    p.add_argument("--force", action="store_true", help="Re-pack even when the pack is fresh.")
    return p, p.parse_args(argv)


def _episode_paths(directory):
    return sorted(glob.glob(os.path.join(directory, "episode_*.np*")))


def main(argv=None) -> int:
    parser, args = parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch.data import pack as pack_lib

    crop_factor = (None if args.crop_factor.lower() in ("none", "null", "")
                   else float(args.crop_factor))
    if args.append:
        return _append(parser, args, pack_lib)
    if not args.data_dir:
        parser.error("--data_dir is required unless --append with --out_dir")
    splits = args.split or ["train", "val"]
    if args.out_dir and len(splits) != 1:
        parser.error("--out_dir requires exactly one --split")
    rc = 0
    for split in splits:
        paths = _episode_paths(os.path.join(args.data_dir, split))
        if not paths:
            print(json.dumps({"split": split, "error": "no_episodes",
                              "dir": os.path.join(args.data_dir, split)}), flush=True)
            rc = 1
            continue
        out_dir = args.out_dir or pack_lib.default_pack_dir(args.data_dir, split)
        t0 = time.perf_counter()
        fresh = not args.force and pack_lib.pack_is_fresh(out_dir, paths, args.height,
                                                          args.width, crop_factor)
        manifest = pack_lib.pack_episodes(paths, out_dir, args.height, args.width, crop_factor,
                                          force=args.force)
        frames = sum(e["steps"] for e in manifest["episodes"])
        ph, pw = manifest["packed"]["height"], manifest["packed"]["width"]
        print(json.dumps({
            "split": split, "out_dir": out_dir, "episodes": len(manifest["episodes"]),
            "frames": frames, "packed_hw": [ph, pw], "bytes": frames * ph * pw * 3,
            "already_fresh": fresh, "seconds": time.perf_counter() - t0,
        }), flush=True)
    return rc


def _append(parser, args, pack_lib) -> int:
    """`--append`: one shard of new episodes onto an existing pack."""
    splits = args.split or ["train"]
    if len(splits) != 1:
        parser.error("--append packs exactly one pack (one --split)")
    split = splits[0]
    if not args.out_dir and not args.data_dir:
        parser.error("--append needs --out_dir (or --data_dir to derive it)")
    out_dir = args.out_dir or pack_lib.default_pack_dir(args.data_dir, split)
    src_dir = args.episodes_dir or (os.path.join(args.data_dir, split) if args.data_dir else None)
    if not src_dir:
        parser.error("--append needs --episodes_dir (or --data_dir)")
    paths = _episode_paths(src_dir)
    if not paths:
        print(json.dumps({"split": split, "error": "no_episodes", "dir": src_dir}), flush=True)
        return 1
    t0 = time.perf_counter()
    try:
        shards_before = len(pack_lib.load_manifest(out_dir)["shards"])
        manifest = pack_lib.append_shard(out_dir, paths)
    except (OSError, ValueError) as exc:
        print(json.dumps({"split": split, "error": "append_failed", "out_dir": out_dir,
                          "detail": str(exc)}), flush=True)
        return 1
    appended = manifest["shards"][shards_before:]
    print(json.dumps({
        "split": split, "out_dir": out_dir,
        "appended_episodes": sum(s["episodes"] for s in appended),
        "appended_shards": [s["frames"] for s in appended],
        "shards": len(manifest["shards"]), "freshness_epoch": manifest["freshness_epoch"],
        "total_steps": manifest["total_steps"], "episodes": len(manifest["episodes"]),
        "seconds": time.perf_counter() - t0,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
