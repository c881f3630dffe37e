"""Run-artifact helpers (counterpart of `rt1_tpu/utils/`): training curves
from the trainer's `metrics.jsonl` and no-clobber archiving."""

from rt1_tpu_torch.utils.artifacts import archive_file, copy_proof_videos
from rt1_tpu_torch.utils.curves import read_scalar_curves, write_loss_curves

__all__ = ["archive_file", "copy_proof_videos", "read_scalar_curves", "write_loss_curves"]
