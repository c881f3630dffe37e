"""Proof-artifact archiving (counterpart of `rt1_tpu/utils/artifacts.py`):
copy run outputs into a directory without clobbering an earlier record.
A rerun with the same name adds a sibling (`name-1.ext`, ...)."""

from __future__ import annotations

import os
import shutil
from typing import Optional


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


def copy_proof_videos(video_dir: str, artifacts_dir: str, prefix: str, max_videos: int = 3):
    """Episode videos are not ported (`eval/evaluate.py`: they need PIL's
    text overlay and a video writer), so this raises."""
    raise ValueError("episode videos are not ported: they need the instruction text overlay "
                     "(PIL) and a video writer (imageio)")
