"""Pure-numpy quasi-static physics for the Language-Table board.

Replaces the reference's PyBullet simulation (`language_table.py:599-646`,
xArm IK + 24x stepSimulation per control step) with a deterministic 2-D
quasi-static contact model: the cylindrical effector sweeps toward its target
and pushes disc-approximated blocks out of its way; block-block overlap is
relaxed iteratively. Blocks on a felt table have negligible momentum at
10 Hz control, so quasi-static pushing is a good model of the real dynamics.

No arm kinematics are simulated: the effector is position-controlled directly
(the reference's IK + position control converges to the target within one
control step anyway). This keeps the backend dependency-free and fast enough
to run thousands of eval episodes on the host's CPU while the card runs the
policy.
"""

import numpy as np

from rt1_tpu_torch.envs import constants

# Object footprints (meters). The real blocks are ~4cm across, the effector
# cylinder ~2.5cm diameter.
EFFECTOR_RADIUS = 0.0125
BLOCK_RADIUS = 0.02

# Where off-board blocks are parked (reference casts them to (5, 5),
# `language_table.py:883-888`).
FAR_AWAY = np.array([5.0, 5.0])

_RELAX_ITERS = 4


class KinematicBackend:
    """Quasi-static 2-D board physics.

    `arm="kinematic"` puts the xArm6 kinematic chain in the loop (the role
    PyBullet's URDF arm plays in the reference, `language_table.py:599-646` +
    `utils/xarm_sim_robot.py:154-187`): each control step solves
    damped-least-squares IK for the target effector pose and sweeps the
    effector along the joint-space interpolation's FK trace, so motion
    follows arm-feasible arcs instead of straight board-frame lines.
    """

    name = "kinematic"

    def __init__(self, block_names=None, arm="none"):
        if block_names is None:
            from rt1_tpu_torch.envs import blocks as blocks_module

            block_names = list(blocks_module.ALL_BLOCKS)
        self._block_names = list(block_names)
        n = len(self._block_names)
        self._index = {b: i for i, b in enumerate(self._block_names)}
        self._block_xy = np.tile(FAR_AWAY, (n, 1))
        self._block_yaw = np.zeros(n)
        self._effector_xy = np.array(
            [constants.CENTER_X, constants.CENTER_Y], dtype=np.float64
        )
        self._effector_target_xy = self._effector_xy.copy()

        if arm not in ("none", "kinematic"):
            raise ValueError(f"arm must be 'none'|'kinematic', got {arm!r}")
        self._arm = None
        self._arm_joints = None
        if arm == "kinematic":
            from rt1_tpu_torch.envs.utils.xarm import (
                HOME_JOINT_POSITIONS,
                XArmKinematics,
            )

            self._arm = XArmKinematics()
            self._arm_joints = np.array(HOME_JOINT_POSITIONS, np.float64)
            self._sync_arm_to_effector()

    # -- arm-in-the-loop ------------------------------------------------

    def _effector_pose(self, xy):
        """Board-frame effector pose for IK: tool at the pushing height,
        flange pointing down (reference cylinder orientation)."""
        from scipy.spatial import transform

        from rt1_tpu_torch.envs.utils.pose3d import Pose3d

        return Pose3d(
            rotation=transform.Rotation.from_euler("xyz", [np.pi, 0.0, 0.0]),
            translation=np.array(
                [xy[0], xy[1], constants.EFFECTOR_HEIGHT]
            ),
        )

    def _sync_arm_to_effector(self):
        q = self._arm.inverse(
            self._effector_pose(self._effector_xy),
            initial_joints=self._arm_joints,
        )
        if q is not None:
            self._arm_joints = q

    def arm_joints(self):
        """Current joint configuration (None when the arm is disabled)."""
        return None if self._arm_joints is None else self._arm_joints.copy()

    # -- poses ----------------------------------------------------------

    @property
    def block_names(self):
        return list(self._block_names)

    def block_pose(self, name):
        i = self._index[name]
        return self._block_xy[i].copy(), float(self._block_yaw[i])

    def set_block_pose(self, name, xy, yaw=0.0):
        i = self._index[name]
        self._block_xy[i] = np.asarray(xy, dtype=np.float64)
        self._block_yaw[i] = float(yaw)

    def park_block(self, name):
        self.set_block_pose(name, FAR_AWAY, 0.0)

    def effector_xy(self):
        return self._effector_xy.copy()

    def effector_target_xy(self):
        return self._effector_target_xy.copy()

    def teleport_effector(self, xy):
        self._effector_xy = np.asarray(xy, dtype=np.float64).copy()
        self._effector_target_xy = self._effector_xy.copy()
        if self._arm is not None:
            self._sync_arm_to_effector()

    def set_effector_target(self, xy):
        self._effector_target_xy = np.asarray(xy, dtype=np.float64).copy()

    # -- stepping -------------------------------------------------------

    def step(self, n_substeps=24):
        """Advance one control period: sweep effector to target, push blocks."""
        start = self._effector_xy
        end = self._effector_target_xy
        sweep = None
        if self._arm is not None:
            sweep = self._arm_sweep(end, n_substeps)
        for k in range(1, n_substeps + 1):
            if sweep is not None:
                self._effector_xy = sweep[k - 1]
            else:
                self._effector_xy = start + (end - start) * (k / n_substeps)
            self._resolve_contacts()
        # Eliminate residual drift so repeated zero-actions are stable.
        self._effector_xy = end.copy()
        self._resolve_contacts()
        # A successful sweep already left _arm_joints at IK(end); only the
        # (rare, out-of-workspace) straight-line fallback needs a re-sync.
        if self._arm is not None and sweep is None:
            self._sync_arm_to_effector()

    def _arm_sweep(self, target_xy, n_substeps):
        """FK trace of the joint-space interpolation toward IK(target).

        Falls back to None (straight-line sweep) when the target is outside
        the arm's reachable workspace — mirroring the reference, where an
        unreachable IK target leaves the arm at its best-effort pose.
        """
        q_target = self._arm.inverse(
            self._effector_pose(target_xy), initial_joints=self._arm_joints
        )
        if q_target is None:
            return None
        q0 = self._arm_joints
        trace = []
        for k in range(1, n_substeps + 1):
            q = q0 + (q_target - q0) * (k / n_substeps)
            trace.append(self._arm.forward(q).translation[:2])
        self._arm_joints = q_target
        return trace

    def stabilize(self, nsteps=100):
        """Quasi-static model has no residual dynamics; just settle contacts."""
        del nsteps
        self._resolve_contacts()

    def _resolve_contacts(self):
        """Quasi-static contact resolution, in scalar float math.

        Runs 25x per control step on a board of at most a few blocks, so
        (as with the RRT* collision checks) per-call numpy overhead on
        tiny arrays dominated the env-step profile; plain float arithmetic
        is ~20x faster here and arithmetically IDENTICAL — including the
        deliberate quirk that block<->block pair distances are computed
        once per `i` iteration and NOT refreshed after a push within it
        (the bit-exact snapshot tests in tests/test_backends.py pin this).
        """
        import math

        xy = self._block_xy
        yaw = self._block_yaw
        ex, ey = float(self._effector_xy[0]), float(self._effector_xy[1])
        min_sep = EFFECTOR_RADIUS + BLOCK_RADIUS
        n_blocks = len(xy)
        # Effector -> block pushout: along the contact normal to exactly
        # touching; a block sitting exactly on the effector center gets a
        # fixed normal. Pushed blocks rotate slightly toward the push
        # direction, approximating the frictional spin of a real shove.
        for i in range(n_blocks):
            dx = float(xy[i, 0]) - ex
            dy = float(xy[i, 1]) - ey
            dist = math.sqrt(dx * dx + dy * dy)
            if dist < min_sep:
                if dist > 1e-9:
                    nx, ny = dx / dist, dy / dist
                else:
                    nx, ny = 1.0, 0.0
                xy[i, 0] = ex + nx * min_sep
                xy[i, 1] = ey + ny * min_sep
                spin = math.atan2(ny, nx)
                yaw[i] += 0.02 * math.sin(spin - float(yaw[i]))
        # Block <-> block overlap relaxation.
        two_r = 2 * BLOCK_RADIUS
        for _ in range(_RELAX_ITERS):
            moved = False
            for i in range(n_blocks):
                # Pair geometry snapshotted at i-loop entry (see docstring).
                xi, yi = float(xy[i, 0]), float(xy[i, 1])
                pair = [
                    (float(xy[j, 0]) - xi, float(xy[j, 1]) - yi)
                    for j in range(n_blocks)
                ]
                for j in range(n_blocks):
                    dx, dy = pair[j]
                    dd = math.sqrt(dx * dx + dy * dy)
                    if dd < two_r and dd > 0:
                        denom = dd if dd > 1e-9 else 1e-9
                        nx, ny = dx / denom, dy / denom
                        push = (two_r - dd) / 2
                        xy[i, 0] -= nx * push
                        xy[i, 1] -= ny * push
                        xy[j, 0] += nx * push
                        xy[j, 1] += ny * push
                        moved = True
            if not moved:
                break

    # -- state save/restore --------------------------------------------

    def get_state(self):
        """Deep-copied snapshot; `set_state` restores it bit-for-bit."""
        state = {
            "block_xy": self._block_xy.copy(),
            "block_yaw": self._block_yaw.copy(),
            "effector_xy": self._effector_xy.copy(),
            "effector_target_xy": self._effector_target_xy.copy(),
        }
        if self._arm_joints is not None:
            state["arm_joints"] = self._arm_joints.copy()
        return state

    def set_state(self, state):
        self._block_xy = np.array(state["block_xy"], dtype=np.float64)
        self._block_yaw = np.array(state["block_yaw"], dtype=np.float64)
        self._effector_xy = np.array(state["effector_xy"], dtype=np.float64)
        self._effector_target_xy = np.array(
            state["effector_target_xy"], dtype=np.float64
        )
        if self._arm is not None:
            if "arm_joints" in state:
                self._arm_joints = np.array(state["arm_joints"], np.float64)
            else:
                # Snapshot from an arm-less backend (cross-backend restore):
                # re-derive joints from the restored effector pose so the
                # next sweep doesn't interpolate from a stale configuration.
                self._sync_arm_to_effector()
