"""Pluggable physics backends for the Language-Table board.

A copy of `rt1_tpu/envs/backends/__init__.py`. The reference runs on
PyBullet (`language_table.py:41-42`); the physics sits behind a small
backend contract (pose get/set, deterministic stepping, bit-exact state
snapshots) so the env runs on numpy alone. There is no PyBullet backend
(pybullet and its URDF assets are not dependencies); `make_backend("auto")`
is an alias of the kinematic backend.
"""

from rt1_tpu_torch.envs.backends.kinematic import KinematicBackend


def make_backend(name="auto", **kwargs):
    if name in ("kinematic", "auto"):
        return KinematicBackend(**kwargs)
    if name == "kinematic_arm":
        # xArm6 FK/IK in the control loop (reference arm-physics parity).
        return KinematicBackend(arm="kinematic", **kwargs)
    if name == "pybullet":
        raise ValueError(
            "There is no PyBullet backend (pybullet is not a dependency). "
            "Use backend='kinematic' or 'kinematic_arm'."
        )
    raise ValueError(f"Unknown physics backend: {name}")


__all__ = ["KinematicBackend", "make_backend"]
