"""Board geometry and observation constants for the Language-Table env.

Parity source: reference `language_table/environments/constants.py:25-65`.
These numbers define the physical workspace, camera, and observation shapes;
they are data, so they must match the reference exactly for train/eval parity.
"""

import math

import numpy as np

# Workspace bounds in robot/base frame (meters). X grows away from the arm
# base ("top" of the image is small x), Y spans left/right.
X_MIN = 0.15
X_MAX = 0.6
Y_MIN = -0.3048
Y_MAX = 0.3048
CENTER_X = (X_MAX - X_MIN) / 2.0 + X_MIN
CENTER_Y = (Y_MAX - Y_MIN) / 2.0 + Y_MIN
WORKSPACE_BOUNDS = np.array(((X_MIN, Y_MIN), (X_MAX, Y_MAX)))
WORKSPACE_BOUNDS_BUFFER = 0.08

# Height at which the cylindrical effector rides above the board, and its
# "pointing down" orientation as a rotation vector.
EFFECTOR_HEIGHT = 0.145
EFFECTOR_DOWN_ROTVEC = (0.0, math.pi, 0.0)

# Rejection-sampling thresholds for initial pose generation.
BLOCK_DISTANCE_THRESHOLD = 0.0175
ARM_DISTANCE_THRESHOLD = 0.06

# Max number of characters in the byte-encoded instruction observation.
INSTRUCTION_LENGTH = 512

# Rendered observation size (RealSense D415-like camera).
IMAGE_WIDTH = 320
IMAGE_HEIGHT = 180
CAMERA_POSE = (0.75, 0.0, 0.5)
CAMERA_ORIENTATION = (np.pi / 5, np.pi, -np.pi / 2)
CAMERA_INTRINSICS = (
    0.803 * IMAGE_WIDTH,  # fx
    0,
    IMAGE_WIDTH / 2.0,  # cx
    0,
    0.803 * IMAGE_WIDTH,  # fy
    IMAGE_HEIGHT / 2.0,  # cy
    0,
    0,
    1,
)

# Sparse-reward radius shared by the block-to-block style tasks
# (reference `rewards/constants.py:17`).
TARGET_BLOCK_DISTANCE = 0.05
