"""Language-Table board environment: geometry, blocks, rewards, simulator
(counterpart of `rt1_tpu/envs/`).

The board, reward and instruction logic is plain numpy (scipy for the arm
kinematics), so every module here is a copy of the JAX package's, apart
from `rendering.py`, which draws the board in numpy instead of PIL. The
physics backend is pluggable; the kinematic numpy backend is the default.
"""

from rt1_tpu_torch.envs import blocks, constants, language, task_info
from rt1_tpu_torch.envs.language_table import LanguageTable

__all__ = ["blocks", "constants", "language", "task_info", "LanguageTable"]
