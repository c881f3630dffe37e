"""Environment utilities: 6-DOF poses + xArm kinematics."""

from rt1_tpu_torch.envs.utils.pose3d import Pose3d
from rt1_tpu_torch.envs.utils.xarm import XArmKinematics

__all__ = ["Pose3d", "XArmKinematics"]
