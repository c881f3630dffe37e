"""UFactory xArm6 kinematics: analytic FK + damped-least-squares IK.

Parity source: reference `language_table/environments/utils/xarm_sim_robot.py:
40-220` — there, FK/IK are delegated to PyBullet's URDF model
(`calculateInverseKinematics`). This module gives the framework arm
kinematics without a physics engine: modified-DH forward kinematics from the
published xArm6 parameter table (UFactory developer manual) and an iterative
damped-least-squares IK with a numeric Jacobian.

Note (documented deviation): joint-space values match the real arm's DH
model; the reference's URDF-derived numbers may differ at the millimeter
level. The contract tested here mirrors the reference test intent
(`utils/xarm_sim_robot_test.py:41-78`): FK determinism and IK∘FK round-trip
to centimeter accuracy.
"""

import dataclasses
from typing import Optional, Sequence

import numpy as np
from scipy.spatial import transform

from rt1_tpu_torch.envs.utils.pose3d import Pose3d

# Modified-DH rows (alpha_{i-1}, a_{i-1}, d_i, theta_offset_i) for xArm6.
_T2_OFFSET = -1.3849179
XARM6_MDH = (
    (0.0, 0.0, 0.267, 0.0),
    (-np.pi / 2, 0.0, 0.0, _T2_OFFSET),
    (0.0, 0.28948866, 0.0, -_T2_OFFSET),
    (-np.pi / 2, 0.0775, 0.3425, 0.0),
    (np.pi / 2, 0.0, 0.0, 0.0),
    (-np.pi / 2, 0.076, 0.097, 0.0),
)

HOME_JOINT_POSITIONS = np.deg2rad([0, -20, -80, 0, 100, -30])

# Per-joint limits (radians), from the xArm6 spec sheet.
JOINT_LIMITS = np.array(
    [
        (-2 * np.pi, 2 * np.pi),
        (-2.059, 2.0944),
        (-3.927, 0.19198),
        (-2 * np.pi, 2 * np.pi),
        (-1.69297, np.pi),
        (-2 * np.pi, 2 * np.pi),
    ]
)


def _mdh_transform(alpha, a, d, theta):
    ca, sa = np.cos(alpha), np.sin(alpha)
    ct, st = np.cos(theta), np.sin(theta)
    return np.array(
        [
            [ct, -st, 0.0, a],
            [st * ca, ct * ca, -sa, -d * sa],
            [st * sa, ct * sa, ca, d * ca],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


@dataclasses.dataclass
class XArmKinematics:
    """FK/IK over the xArm6 chain (tool frame = flange)."""

    mdh: Sequence = XARM6_MDH
    joint_limits: np.ndarray = dataclasses.field(
        default_factory=lambda: JOINT_LIMITS.copy()
    )

    def forward(self, joints: np.ndarray) -> Pose3d:
        """Joint angles (6,) -> flange pose in the base frame."""
        joints = np.asarray(joints, np.float64)
        m = np.eye(4)
        for (alpha, a, d, offset), q in zip(self.mdh, joints):
            m = m @ _mdh_transform(alpha, a, d, q + offset)
        return Pose3d.from_matrix(m)

    forward_kinematics = forward

    def _pose_error(self, joints, target: Pose3d):
        cur = self.forward(joints)
        pos_err = target.translation - cur.translation
        rot_err = (target.rotation * cur.rotation.inv()).as_rotvec()
        return np.concatenate([pos_err, rot_err])

    def inverse(
        self,
        target: Pose3d,
        initial_joints: Optional[np.ndarray] = None,
        max_iters: int = 200,
        tol: float = 1e-5,
        damping: float = 1e-3,
        step_scale: float = 1.0,
    ) -> Optional[np.ndarray]:
        """Damped-least-squares IK; None when it fails to converge.

        Equivalent role to PyBullet's `calculateInverseKinematics` in the
        reference (`xarm_sim_robot.py:154-187`), which also iterates from
        the current configuration.
        """
        q = np.array(
            initial_joints
            if initial_joints is not None
            else HOME_JOINT_POSITIONS,
            np.float64,
        )
        eps = 1e-6
        for _ in range(max_iters):
            err = self._pose_error(q, target)
            if np.linalg.norm(err) < tol:
                # q is already limit-clipped every iteration; no re-wrapping
                # (joint 3's range extends below -pi, so a naive [-pi, pi)
                # wrap would corrupt valid solutions).
                return q
            # Numeric Jacobian, central differences.
            jac = np.zeros((6, 6))
            for j in range(6):
                dq = np.zeros(6)
                dq[j] = eps
                jac[:, j] = (
                    self._pose_error(q + dq, target)
                    - self._pose_error(q - dq, target)
                ) / (2 * eps)
            # err(q+dq) ≈ err(q) + J dq → solve J dq = -(-err) ... the error
            # decreases along +J⁺·err since err is target-minus-current.
            jtj = jac.T @ jac + damping * np.eye(6)
            dq = np.linalg.solve(jtj, jac.T @ err)
            q = q - step_scale * dq
            q = np.clip(q, self.joint_limits[:, 0], self.joint_limits[:, 1])
        err = self._pose_error(q, target)
        if np.linalg.norm(err) < 1e-3:
            return q
        return None

    inverse_kinematics = inverse
