"""Proof-artifact archiving (counterpart of `rt1_tpu/utils/artifacts.py`):
copy run outputs into a directory without clobbering an earlier record.
A rerun with the same name adds a sibling (`name-1.ext`, ...)."""

from __future__ import annotations

import glob
import os
import shutil
from typing import List, Optional


def archive_file(src: str, artifacts_dir: str, dest_name: str) -> Optional[str]:
    """Copy `src` to `<artifacts_dir>/<dest_name>`, made unique on a
    conflict. Returns the destination, or None when `src` does not exist."""
    if not os.path.exists(src):
        return None
    dest = os.path.join(artifacts_dir, dest_name)
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    stem, ext = os.path.splitext(dest)
    n = 1
    while os.path.exists(dest):
        dest = f"{stem}-{n}{ext}"
        n += 1
    shutil.copy2(src, dest)
    return dest


def copy_proof_videos(video_dir: str, artifacts_dir: str, prefix: str,
                      max_videos: int = 3) -> List[str]:
    """Stage up to `max_videos` episode videos (successes first) into
    `<artifacts_dir>/learn_proof_videos/` as `<prefix>_<name>`, so that
    reruns never clobber an earlier record. Returns the archived paths."""
    if not os.path.isdir(video_dir):
        return []
    vids = sorted(glob.glob(os.path.join(video_dir, "*success*"))) + \
        sorted(glob.glob(os.path.join(video_dir, "*failure*")))
    out = []
    for src in vids[:max_videos]:
        dest = archive_file(src, artifacts_dir, os.path.join(
            "learn_proof_videos", f"{prefix}_{os.path.basename(src)}"))
        if dest:
            out.append(dest)
    return out
