"""Oriented push oracle + RRT-planned obstacle-avoiding variant.

Parity source: reference `language_table/environments/oracles/
oriented_push_oracle.py:44-240` (phase state machine: approach the pre-block
point on the block-target line, orient the block when its yaw error is large,
then push) and `push_oracle_rrt_slowdown.py:95-731` (RRT* subgoal planning
for both the pushed block and the free-space end-effector approach, replan /
backoff recovery, near-goal slowdown).

These are plain Python policies over the env's raw state dict — no tf_agents
dependency. `action(raw_state)` returns a (2,) delta; `get_plan(raw_state)`
is used by the eval harness to validate episode inits.
"""

import collections
import dataclasses
from typing import Any, Optional

import numpy as np

from rt1_tpu_torch.envs import constants

# Planning constants (reference `push_oracle_rrt_slowdown.py:29-76`).
BLOCK_DIAMETER = 0.015
ADVANCE_TO_NEXT_SUBGOAL_THRESHOLD = 0.025
PREBLOCK_OFFSET = 0.05
EE_BACKOFF_OFFSETS = [0.06, 0.07, 0.08]
RRT_COLLISION_THRESHOLD = 0.015
RRT_STEP_LENGTH = 0.05
RRT_GOAL_SAMPLE_RATE = 0.1
RRT_SEARCH_RADIUS = 0.5
RRT_MAX_ITERS = 1024
REPLAN_IF_FAILURE = True
RETRY_FOR_NEW_PLAN_EVERY = 10
ADVANCE_TO_NEXT_EE_SUBGOAL_THRESHOLD = 0.01
EPS = 1e-5
BEYOND_TABLE_THRESHOLD = 2.0
EE_RRT_STEP_LENGTH = 0.025
EE_RRT_DELTA = 0.01
EE_RRT_OBSTACLE_RADIUS = 0.02
EE_RRT_ITER_MAX = 2048
RETRY_FOR_NEW_EE_PLAN_EVERY = 1
EXTRA_BOUNDARY_BUFFER = 0.04

X_RANGE_RRT = (constants.X_MIN, constants.X_MAX + EXTRA_BOUNDARY_BUFFER)
Y_RANGE_RRT = (
    constants.Y_MIN - EXTRA_BOUNDARY_BUFFER,
    constants.Y_MAX + EXTRA_BOUNDARY_BUFFER,
)


@dataclasses.dataclass
class PushingInfo:
    """Geometry snapshot consumed by the pushing state machine."""

    xy_block: Any = None
    xy_ee: Any = None
    xy_pre_block: Any = None
    xy_dir_block_to_target: Any = None
    xy_delta_to_nexttoblock: Any = None
    xy_delta_to_touchingblock: Any = None
    xy_dir_block_to_ee: Any = None
    theta_threshold_to_orient: Any = None
    theta_threshold_flat_enough: Any = None
    theta_error: Any = None
    obstacle_poses: Any = None
    distance_to_target: Any = None


def _rotate(theta, v):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]]) @ v


def filter_subgoals(path, min_distance):
    """Thin a goal->start path so consecutive kept subgoals are spaced out."""
    path = collections.deque(path)
    keep = collections.deque([path.pop()])
    for _ in range(len(path)):
        candidate = path.pop()
        if np.linalg.norm(np.array(candidate) - np.array(keep[0])) >= min_distance:
            keep.appendleft(candidate)
    return keep


class OrientedPushOracle:
    """Phase machine: move to pre-block -> approach -> orient -> push."""

    def __init__(self, env, action_noise_std=0.0, seed=0):
        self._env = env
        self._rng = np.random.RandomState(seed)
        self._action_noise_std = action_noise_std
        self.phase = "move_to_pre_block"

    def reset(self):
        self.phase = "move_to_pre_block"

    def action(self, raw_state=None):
        if raw_state is None:
            raw_state = self._env.compute_state()
        return self._get_action_for_block_target(raw_state)

    # -- geometry -------------------------------------------------------

    def _control_period(self):
        return 1.0 / getattr(self._env, "_control_frequency", 10.0)

    def _get_action_info(self, raw_state):
        xy_ee = raw_state["effector_target_translation"][:2]
        xy_target = (
            xy_ee
            + raw_state["effector_target_to_task_target_translation"][:2]
        )
        xy_block = (
            xy_ee
            + raw_state["effector_target_to_start_block_translation"][:2]
        )
        theta_block = raw_state["start_block_orientation"]

        to_target = xy_target - xy_block
        dir_to_target = to_target / (
            np.linalg.norm(to_target) + np.finfo(np.float32).eps
        )
        theta_to_target = np.arctan2(dir_to_target[1], dir_to_target[0])

        # Square-ish blocks have 4-way symmetry: wrap into (-pi/4, pi/4].
        theta_error = theta_to_target - theta_block
        while theta_error > np.pi / 4:
            theta_error -= np.pi / 2
        while theta_error < -np.pi / 4:
            theta_error += np.pi / 2

        xy_pre_block = xy_block + -dir_to_target * PREBLOCK_OFFSET
        xy_nexttoblock = xy_block + -dir_to_target * 0.03
        xy_touchingblock = xy_block + -dir_to_target * 0.01

        to_ee = xy_ee - xy_block
        dir_to_ee = to_ee / (np.linalg.norm(to_ee) + np.finfo(np.float32).eps)

        return PushingInfo(
            xy_block=xy_block,
            xy_ee=xy_ee,
            xy_pre_block=xy_pre_block,
            xy_dir_block_to_target=dir_to_target,
            xy_delta_to_nexttoblock=xy_nexttoblock - xy_ee,
            xy_delta_to_touchingblock=xy_touchingblock - xy_ee,
            xy_dir_block_to_ee=dir_to_ee,
            theta_threshold_to_orient=0.2,
            theta_threshold_flat_enough=0.03,
            theta_error=float(np.asarray(theta_error).reshape(-1)[0]),
            distance_to_target=float(np.linalg.norm(to_target)),
        )

    # -- phases ---------------------------------------------------------

    def _phase_move_to_pre_block(self, info):
        delta = info.xy_pre_block - info.xy_ee
        if np.linalg.norm(delta) < 0.001:
            self.phase = "move_to_block"
        return delta, 0.3

    def _phase_move_to_block(self, info, advance_threshold=0.001):
        if np.linalg.norm(info.xy_delta_to_nexttoblock) < advance_threshold:
            self.phase = "push_block"
        if info.theta_error > info.theta_threshold_to_orient:
            self.phase = "orient_block_left"
        if info.theta_error < -info.theta_threshold_to_orient:
            self.phase = "orient_block_right"
        return info.xy_delta_to_nexttoblock

    def _phase_push_block(self, info):
        if abs(info.theta_error) > info.theta_threshold_to_orient:
            self.phase = "move_to_pre_block"
        return info.xy_delta_to_touchingblock

    def _phase_orient(self, info, sign):
        """Circle around the block to spin it; sign=+1 left, -1 right."""
        orient_circle_diameter = 0.025
        direction = _rotate(sign * 0.2, info.xy_dir_block_to_ee)
        spot = info.xy_block + direction * orient_circle_diameter
        if sign > 0 and info.theta_error < info.theta_threshold_flat_enough:
            self.phase = "move_to_pre_block"
        if sign < 0 and info.theta_error > -info.theta_threshold_flat_enough:
            self.phase = "move_to_pre_block"
        return spot - info.xy_ee

    def _get_action_for_block_target(self, raw_state):
        max_step_velocity = 0.35
        info = self._get_action_info(raw_state)

        if self.phase == "move_to_pre_block":
            xy_delta, max_step_velocity = self._phase_move_to_pre_block(info)
        if self.phase == "move_to_block":
            xy_delta = self._phase_move_to_block(info)
        if self.phase == "push_block":
            xy_delta = self._phase_push_block(info)
        if self.phase in ("orient_block_left", "orient_block_right"):
            max_step_velocity = 0.15
        if self.phase == "orient_block_left":
            xy_delta = self._phase_orient(info, +1)
        if self.phase == "orient_block_right":
            xy_delta = self._phase_orient(info, -1)

        if self._action_noise_std:
            xy_delta = xy_delta + self._rng.randn(2) * self._action_noise_std

        max_step = max_step_velocity * self._control_period()
        length = np.linalg.norm(xy_delta)
        if length > max_step:
            xy_delta = xy_delta / length * max_step
        return np.asarray(xy_delta, dtype=np.float32)


class RRTPushOracle(OrientedPushOracle):
    """Push oracle that plans collision-free subgoal chains with RRT*.

    Two planners: one for the *block's* path to the task target, one for the
    *end effector's* free-space approach to the pre-block point. Both replan
    on failure with back-off offsets; near-goal actions are slowed for
    precision (reference `push_oracle_rrt_slowdown.py:311-319`).
    """

    def __init__(
        self,
        env,
        use_ee_planner=True,
        action_noise_std=0.0,
        slowdown_freespace=False,
        backoff_subgoal_rrt=True,
        replan_ee_rrt=True,
        backoff_ee_rrt=True,
        filter_ee_obstacle_poses=True,
        block_diameter=BLOCK_DIAMETER,
        rrt_collision_threshold=RRT_COLLISION_THRESHOLD,
        seed=0,
    ):
        super().__init__(env, action_noise_std=action_noise_std, seed=seed)
        self.phase = "move_to_pre_block_avoid"
        self._use_ee_planner = use_ee_planner
        self._slowdown_freespace = slowdown_freespace
        self._backoff_subgoal_rrt = backoff_subgoal_rrt
        self._replan_ee_rrt = replan_ee_rrt
        self._backoff_ee_rrt = backoff_ee_rrt
        self._filter_ee_obstacle_poses = filter_ee_obstacle_poses
        self._block_diameter = block_diameter
        self._rrt_collision_threshold = rrt_collision_threshold

        self._plan = None
        self._current_rrt_target = None
        self._need_replan = False
        self._replan_counter = 0
        self._ee_plan = None
        self._current_ee_target = None
        self._ee_plan_success = None
        self._need_ee_replan = None
        self._ee_replan_counter = 0
        self._prev_instruction = None

    def reset(self):
        self.phase = "move_to_pre_block_avoid"
        self._current_rrt_target = None
        self._current_ee_target = None
        self._ee_plan = None
        self._replan_counter = 0
        self._ee_replan_counter = 0

    # -- obstacle extraction -------------------------------------------

    def _get_obstacle_poses(self, raw_state):
        poses = [
            raw_state[k][:2]
            for k in raw_state
            if k.startswith("block_") and "translation" in k
        ]
        # On-table blocks only (parked blocks live at (5, 5)).
        return [p for p in poses if np.max(p) < BEYOND_TABLE_THRESHOLD]

    # -- block-path planning -------------------------------------------

    def get_plan(self, raw_state):
        """Plan block subgoals to the task target. Returns plan success."""
        from rt1_tpu_torch.envs.oracles.rrt_star import plan_shortest_path

        xy_ee = raw_state["effector_target_translation"][:2]
        xy_target = (
            xy_ee
            + raw_state["effector_target_to_task_target_translation"][:2]
        )
        xy_block = (
            xy_ee
            + raw_state["effector_target_to_start_block_translation"][:2]
        )
        obstacles = self._get_obstacle_poses(raw_state)
        # Neither the pushed block nor a block-target counts as an obstacle.
        obstacles = [
            o
            for o in obstacles
            if np.linalg.norm(xy_block - o) > EPS
            and np.linalg.norm(xy_target - o) > EPS
        ]

        def _plan_to(goal):
            path, ok = plan_shortest_path(
                xy_start=xy_block,
                xy_goal=goal,
                x_range=X_RANGE_RRT,
                y_range=Y_RANGE_RRT,
                obstacle_xy=obstacles,
                obstacle_widths=[self._block_diameter] * len(obstacles),
                delta=self._rrt_collision_threshold,
                step_length=RRT_STEP_LENGTH,
                goal_sample_rate=RRT_GOAL_SAMPLE_RATE,
                search_radius=RRT_SEARCH_RADIUS,
                iter_max=RRT_MAX_ITERS,
                rng=self._rng,
            )
            return collections.deque(path), ok

        path, success = _plan_to(xy_target)

        if not success and self._backoff_subgoal_rrt:
            # block2block-relative targets sit right next to a block; back the
            # goal off along the offset ray until it becomes plannable.
            from rt1_tpu_torch.envs.rewards.block2block_relative import (
                is_block2block_relative_pair,
            )

            near = [
                o
                for o in obstacles
                if is_block2block_relative_pair(o, xy_target)
            ]
            if near:
                anchor = near[0]
                ray = xy_target - anchor
                for scale in [1.1, 1.2, 1.3, 1.4, 1.5]:
                    new_path, success = _plan_to(anchor + ray * scale)
                    if success:
                        new_path.appendleft(list(xy_target))
                        path = new_path
                        break

        self._need_replan = not success and REPLAN_IF_FAILURE

        if len(path) > 1:
            path.pop()  # rightmost is xy_start
        path = filter_subgoals(path, ADVANCE_TO_NEXT_SUBGOAL_THRESHOLD)
        self._current_rrt_target = np.asarray(path.pop())
        self._plan = path
        return success

    def _maybe_advance_subgoal(self, info, raw_state):
        if (
            info.distance_to_target <= ADVANCE_TO_NEXT_SUBGOAL_THRESHOLD
            and self._plan
        ):
            self._current_rrt_target = np.asarray(self._plan.pop())
            info = self._get_action_info(raw_state)
        return info

    # -- ee-path planning ----------------------------------------------

    def _filtered_ee_obstacles(self, obstacles, xy_target, pushing_block):
        """Drop blocks already touching the ee goal (except the push block)."""
        out = []
        for o in obstacles:
            in_collision = np.linalg.norm(o - xy_target) < 0.05
            is_push_block = np.linalg.norm(o - pushing_block) < 1e-6
            if in_collision and not is_push_block:
                continue
            out.append(o)
        return out

    def _get_ee_plan(self, raw_state, info):
        from rt1_tpu_torch.envs.oracles.rrt_star import plan_shortest_path

        xy_ee = raw_state["effector_target_translation"][:2]
        offsets = [PREBLOCK_OFFSET]
        if self._backoff_ee_rrt:
            offsets = offsets + EE_BACKOFF_OFFSETS
        success, path = False, None
        for offset in offsets:
            xy_target = info.xy_block + -info.xy_dir_block_to_target * offset
            obstacles = self._get_obstacle_poses(raw_state)
            if self._filter_ee_obstacle_poses:
                obstacles = self._filtered_ee_obstacles(
                    obstacles, xy_target, info.xy_block
                )
            path, success = plan_shortest_path(
                xy_start=xy_ee,
                xy_goal=xy_target,
                x_range=X_RANGE_RRT,
                y_range=Y_RANGE_RRT,
                obstacle_xy=obstacles,
                obstacle_widths=[EE_RRT_OBSTACLE_RADIUS] * len(obstacles),
                delta=EE_RRT_DELTA,
                step_length=EE_RRT_STEP_LENGTH,
                goal_sample_rate=RRT_GOAL_SAMPLE_RATE,
                search_radius=RRT_SEARCH_RADIUS,
                iter_max=EE_RRT_ITER_MAX,
                rng=self._rng,
            )
            if success:
                break

        self._need_ee_replan = not success and self._replan_ee_rrt
        path = filter_subgoals(path, ADVANCE_TO_NEXT_EE_SUBGOAL_THRESHOLD)
        # The plan targets a backed-off point; make the true pre-block point
        # the final subgoal.
        final = list(info.xy_pre_block)
        if np.linalg.norm(np.array(path[0]) - np.array(final)) >= EPS:
            path.appendleft(final)
        if len(path) > 1:
            path.pop()
        self._current_ee_target = np.asarray(path.pop())
        self._ee_plan = path
        self._ee_plan_success = success

    def _maybe_advance_ee_subgoal(self, info, raw_state):
        diff = np.linalg.norm(self._current_ee_target - info.xy_ee)
        if diff < ADVANCE_TO_NEXT_EE_SUBGOAL_THRESHOLD and self._ee_plan:
            self._current_ee_target = np.asarray(self._ee_plan.pop())
            info = self._get_action_info(raw_state)
        if not self._ee_plan:
            # Track the live pre-block point once the open-loop plan is spent.
            self._current_ee_target = info.xy_pre_block
        return info

    # -- freespace approach phase --------------------------------------

    def _phase_move_to_pre_block_avoid(self, info, raw_state):
        if self._current_ee_target is None and self._use_ee_planner:
            self._get_ee_plan(raw_state, info)
        self._ee_replan_counter += 1
        if (
            self._replan_ee_rrt
            and self._need_ee_replan
            and self._ee_replan_counter % RETRY_FOR_NEW_EE_PLAN_EVERY == 0
        ):
            self._get_ee_plan(raw_state, info)

        if self._use_ee_planner:
            info = self._maybe_advance_ee_subgoal(info, raw_state)
        if self._use_ee_planner and self._ee_plan_success:
            delta = self._current_ee_target - info.xy_ee
            if np.linalg.norm(delta) < 0.001:
                self.phase = "move_to_block"
            return info, delta, 0.3
        return info, *self._phase_avoid_potential(info)

    def _phase_avoid_potential(self, info):
        """Potential-field fallback when the ee planner failed."""
        to_preblock = info.xy_pre_block - info.xy_ee
        delta = np.zeros(2)

        for pose in info.obstacle_poses or []:
            d = np.linalg.norm(info.xy_ee - pose)
            theta = np.arctan2(
                pose[1] - info.xy_ee[1], pose[0] - info.xy_ee[0]
            )
            r, s = 0.029, 0.03
            if d < r:
                delta += -np.sign([np.cos(theta), np.sin(theta)]) * 1e9
            elif d <= s + r:
                delta += (
                    -500 * (s + r - d) * np.array([np.cos(theta), np.sin(theta)])
                )

        gd = np.linalg.norm(to_preblock)
        gtheta = np.arctan2(to_preblock[1], to_preblock[0])
        r = 0.03
        if gd > 2 * r:
            delta += 300 * 0.03 * np.array([np.cos(gtheta), np.sin(gtheta)])
        elif gd >= r:
            delta += 550 * 0.03 * np.array([np.cos(gtheta), np.sin(gtheta)])
        else:
            delta += 1000 * r * np.array([np.cos(gtheta), np.sin(gtheta)])

        if gd < 0.015:
            delta = to_preblock
        if gd < 0.01:
            self.phase = "move_to_block"
            delta = to_preblock
        return delta, 0.3

    # -- slowdown + main dispatch --------------------------------------

    @staticmethod
    def _maybe_slowdown(dist, max_step):
        for thresh, slow in zip(
            [0.02, 0.04, 0.06, 0.08, 0.1], [0.2, 0.3, 0.4, 0.5, 0.6]
        ):
            if dist < thresh:
                return max_step * slow
        return max_step

    def _get_action_info(self, raw_state):
        info = super()._get_action_info(raw_state)
        # Retarget geometry at the current RRT subgoal while subgoals remain;
        # only the final leg chases the live task target.
        if self._plan:
            xy_target = np.asarray(self._current_rrt_target)
            to_target = xy_target - info.xy_block
            dir_to_target = to_target / (
                np.linalg.norm(to_target) + np.finfo(np.float32).eps
            )
            theta_to_target = np.arctan2(dir_to_target[1], dir_to_target[0])
            theta_block = raw_state["start_block_orientation"]
            theta_error = theta_to_target - theta_block
            while theta_error > np.pi / 4:
                theta_error -= np.pi / 2
            while theta_error < -np.pi / 4:
                theta_error += np.pi / 2
            info.xy_dir_block_to_target = dir_to_target
            info.theta_error = float(np.asarray(theta_error).reshape(-1)[0])
            info.xy_pre_block = info.xy_block + -dir_to_target * PREBLOCK_OFFSET
            info.xy_delta_to_nexttoblock = (
                info.xy_block + -dir_to_target * 0.03 - info.xy_ee
            )
            info.xy_delta_to_touchingblock = (
                info.xy_block + -dir_to_target * 0.01 - info.xy_ee
            )
            info.distance_to_target = float(np.linalg.norm(to_target))
        info.obstacle_poses = self._get_obstacle_poses(raw_state)
        return info

    def _get_action_for_block_target(self, raw_state):
        if "instruction" in raw_state:
            cur = raw_state["instruction"]
            if self._prev_instruction is not None and np.linalg.norm(
                self._prev_instruction - cur
            ) > 0.0:
                self.reset()
            self._prev_instruction = cur

        if self._current_rrt_target is None:
            self.get_plan(raw_state)
        self._replan_counter += 1
        if (
            REPLAN_IF_FAILURE
            and self._need_replan
            and self._replan_counter % RETRY_FOR_NEW_PLAN_EVERY == 0
        ):
            self.get_plan(raw_state)

        info = self._get_action_info(raw_state)
        info = self._maybe_advance_subgoal(info, raw_state)

        max_step_velocity = 0.35
        if self.phase == "move_to_pre_block_avoid":
            info, xy_delta, max_step_velocity = (
                self._phase_move_to_pre_block_avoid(info, raw_state)
            )
        if self.phase == "move_to_pre_block":
            xy_delta, max_step_velocity = self._phase_move_to_pre_block(info)
        if self.phase == "move_to_block":
            xy_delta = self._phase_move_to_block(info, advance_threshold=0.01)
        if self.phase == "push_block":
            xy_delta = self._phase_push_block(info)
        if self.phase in ("orient_block_left", "orient_block_right"):
            max_step_velocity = 0.15
        if self.phase == "orient_block_left":
            xy_delta = self._phase_orient(info, +1)
        if self.phase == "orient_block_right":
            xy_delta = self._phase_orient(info, -1)

        if self._action_noise_std:
            xy_delta = xy_delta + self._rng.randn(2) * self._action_noise_std

        max_step = max_step_velocity * self._control_period()
        in_freespace = self.phase == "move_to_pre_block_avoid"
        if not in_freespace or self._slowdown_freespace:
            max_step = self._maybe_slowdown(info.distance_to_target, max_step)
        length = np.linalg.norm(xy_delta)
        if length > max_step:
            xy_delta = xy_delta / length * max_step
        return np.asarray(xy_delta, dtype=np.float32)
