"""The Language-Table gym-style environment.

A copy of `rt1_tpu/envs/language_table.py`, drawing through the port's
numpy `render_board`; `render()` with `render_text_in_image=True` adds the
instruction overlay (`rendering.add_debug_info_to_image`, in the port's own
bitmap font). Parity source: reference
`language_table/environments/language_table.py:45-199`
(reset/step/render/succeeded/encode/decode/state save-restore). Physics runs
on a pluggable backend (see `backends/`); everything else —
board sampling, task/instruction sampling, observation layout, reward
plumbing — reproduces the reference semantics.

Observation dict (matching `language_table.py:407-416`):
  effector_translation          (2,) float32 actual effector xy
  effector_target_translation   (2,) float32 commanded effector xy
  instruction                   (512,) int32 utf-8 bytes, zero padded
  rgb                           (180, 320, 3) uint8 rendered board

Action: (2,) float32 delta xy in [-0.1, 0.1] per 0.1s control step.
"""

import collections
import copy

import numpy as np

from rt1_tpu_torch.envs import blocks as blocks_module
from rt1_tpu_torch.envs import constants, task_info
from rt1_tpu_torch.envs.backends import make_backend
from rt1_tpu_torch.envs.rendering import add_debug_info_to_image, render_board


class LanguageTable:
    """2-D tabletop block-pushing env driven by natural-language tasks."""

    def __init__(
        self,
        block_mode,
        training=True,
        reward_factory=None,
        control_frequency=10.0,
        seed=None,
        delay_reward_steps=0,
        render_text_in_image=True,
        backend="kinematic",
        backend_kwargs=None,
        step_frequency=240.0,
    ):
        self._block_mode = blocks_module.BlockMode(block_mode)
        self._training = training
        self._rng = np.random.RandomState(seed=seed)
        self._render_text_in_image = render_text_in_image

        self._instruction = self.encode_instruction(None)
        self._instruction_str = None
        self._task_info = None
        self._start_block = blocks_module.block_set(self._block_mode)[0]
        self._oracle_target_block = None
        self._oracle_target_translation = None
        self._target_absolute_location = None
        self._target_relative_location = None

        self._image_size = (constants.IMAGE_HEIGHT, constants.IMAGE_WIDTH)

        if step_frequency % control_frequency != 0:
            raise ValueError(
                "Control frequency must divide the simulation step frequency."
            )
        self._control_frequency = control_frequency
        self._sim_steps_per_step = int(step_frequency / control_frequency)

        backend_kwargs = dict(backend_kwargs or {})
        backend_kwargs.setdefault(
            "block_names", list(blocks_module.block_set(self._block_mode))
        )
        self._backend = make_backend(backend, **backend_kwargs)

        self._reward_calculator = None
        if reward_factory is not None:
            self._reward_calculator = reward_factory(
                goal_reward=100.0,
                rng=self._rng,
                delay_reward_steps=delay_reward_steps,
                block_mode=self._block_mode,
            )

        self._blocks_on_table = list(blocks_module.block_set(self._block_mode))
        self.reset()

    # -- spaces ---------------------------------------------------------

    @property
    def action_space_low(self):
        return np.array([-0.1, -0.1], np.float32)

    @property
    def action_space_high(self):
        return np.array([0.1, 0.1], np.float32)

    def observation_shapes(self):
        return collections.OrderedDict(
            effector_translation=(2,),
            effector_target_translation=(2,),
            instruction=(constants.INSTRUCTION_LENGTH,),
            rgb=(*self._image_size, 3),
        )

    # -- gym API --------------------------------------------------------

    def seed(self, seed=None):
        self._rng = np.random.RandomState(seed=seed)
        if self._reward_calculator is not None:
            self._reward_calculator.seed(self._rng)

    def reset(self, reset_poses=True):
        if reset_poses:
            combos = blocks_module.block_subsets(
                self._block_mode, self._training
            )
            combo_idx = self._rng.choice(range(len(combos)))
            blocks_on_table = list(combos[combo_idx])
            self._reset_poses_randomly(blocks_on_table)
        else:
            # State-restore path: keep the block subset that was restored
            # rather than drawing a fresh combo.
            blocks_on_table = list(self._blocks_on_table)

        self._blocks_on_table = blocks_on_table
        # On the state-restore path the task info was just restored from the
        # snapshot; asking the (unrestored) reward for a task update would
        # clobber it with the previous episode's task.
        state = self._compute_state(request_task_update=reset_poses)
        self._previous_state = state
        return self._compute_observation(state=state)

    def step(self, action):
        self._step_robot_and_sim(action)
        state = self._compute_state()
        if self._reward_calculator is None:
            reward, done = 0.0, False
        else:
            reward, done = self._reward_calculator.reward(state)
        observation = self._compute_observation(state=state)
        return observation, reward, done, {}

    def render(self, mode="rgb_array"):
        del mode
        image = self._render_image()
        if not self._render_text_in_image:
            return image
        debug_info = {}
        if self._instruction_str is not None:
            debug_info["instruction"] = self._instruction_str
        return add_debug_info_to_image(image, debug_info)

    @property
    def succeeded(self):
        if self._reward_calculator is None:
            return False
        state = self._compute_state()
        # Peeking must not advance the delayed-reward counter.
        saved_zone_steps = self._reward_calculator._in_reward_zone_steps
        reward, _ = self._reward_calculator.reward(state)
        self._reward_calculator._in_reward_zone_steps = saved_zone_steps
        return reward > 0.0

    @property
    def instruction_str(self):
        return self._instruction_str

    @property
    def blocks_on_table(self):
        return list(self._blocks_on_table)

    @property
    def backend(self):
        return self._backend

    # -- instruction byte codec (reference `language_table.py:208-232`) --

    @staticmethod
    def encode_instruction(instruction):
        if not instruction:
            return np.zeros(constants.INSTRUCTION_LENGTH, dtype=np.int32)
        raw = list(instruction.encode("utf-8"))
        if len(raw) > constants.INSTRUCTION_LENGTH:
            raise ValueError(
                "Instruction length too long %d > %d; %s"
                % (len(raw), constants.INSTRUCTION_LENGTH, instruction)
            )
        raw = raw + [0] * (constants.INSTRUCTION_LENGTH - len(raw))
        return np.array(raw, dtype=np.int32)

    @staticmethod
    def decode_instruction(bytes_list):
        non_zero = bytes_list[np.where(bytes_list != 0)]
        if non_zero.shape[0] == 0:
            return ""
        return bytes(non_zero.tolist()).decode("utf-8")

    # -- state save / restore (reference `:234-359`) ---------------------

    def get_board_state(self):
        """Serializable snapshot: physics + task metadata."""
        state = {
            "physics": self._backend.get_state(),
            "blocks_on_table": list(self._blocks_on_table),
        }
        text_fields = dict(
            start_block=self._start_block,
            oracle_target_block=self._oracle_target_block,
            target_absolute_location=self._target_absolute_location,
            target_relative_location=self._target_relative_location,
            instruction_str=self._instruction_str,
        )
        for key, value in text_fields.items():
            if value is not None:
                state[key] = self.encode_instruction(value).tolist()
        if self._oracle_target_translation is not None:
            state["oracle_target_translation"] = (
                np.asarray(self._oracle_target_translation).tolist()
            )
        if self._instruction is not None:
            state["instruction"] = self._instruction.tolist()
        # Snapshot the reward calculator's task internals (chosen blocks,
        # targets, zone counters) so post-restore step()/reward() score the
        # restored task, not whatever episode ran since.
        if self._reward_calculator is not None:
            state["reward_state"] = {
                k: copy.deepcopy(v)
                for k, v in self._reward_calculator.__dict__.items()
                if k != "_rng"
            }
        return state

    def set_board_state(self, state):
        self._backend.set_state(state["physics"])
        self._blocks_on_table = list(state["blocks_on_table"])
        for key in (
            "start_block",
            "oracle_target_block",
            "target_absolute_location",
            "target_relative_location",
            "instruction_str",
        ):
            if key in state:
                setattr(
                    self,
                    "_" + key,
                    self.decode_instruction(np.array(state[key])),
                )
            else:
                # Absent in the snapshot means it was None at save time;
                # clear any value left over from the current episode.
                setattr(self, "_" + key, None)
        self._oracle_target_translation = None
        if "oracle_target_translation" in state:
            self._oracle_target_translation = np.array(
                state["oracle_target_translation"]
            )
        if "instruction" in state:
            instruction = state["instruction"]
            if len(instruction) < constants.INSTRUCTION_LENGTH:
                instruction = np.pad(
                    instruction,
                    (0, constants.INSTRUCTION_LENGTH - len(instruction)),
                )
            self._instruction = np.array(instruction, dtype=np.int32)
        if "reward_state" in state and self._reward_calculator is not None:
            self._reward_calculator.__dict__.update(
                copy.deepcopy(state["reward_state"])
            )
        self.reset(reset_poses=False)

    # Aliases matching the reference method names.
    get_pybullet_state = get_board_state
    set_pybullet_state = set_board_state

    # -- internals ------------------------------------------------------

    def _render_image(self):
        poses = {
            b: self._backend.block_pose(b) for b in self._blocks_on_table
        }
        goal = None
        if self._reward_calculator is not None:
            goal = self._reward_calculator.get_goal_region()
        return render_board(
            poses,
            self._backend.effector_xy(),
            image_size=self._image_size,
            goal_region=goal,
        )

    def _step_robot_and_sim(self, action):
        """Clip the delta action into workspace bounds and advance physics."""
        target = self._backend.effector_target_xy() + np.asarray(action[:2])
        target = np.clip(
            target,
            constants.WORKSPACE_BOUNDS[0],
            constants.WORKSPACE_BOUNDS[1],
        )
        self._backend.set_effector_target(target)
        self._backend.step(self._sim_steps_per_step)

    def _compute_observation(self, state=None):
        if state is None:
            state = self._compute_state()
        return collections.OrderedDict(
            effector_translation=state["effector_translation"],
            effector_target_translation=state["effector_target_translation"],
            instruction=state["instruction"],
            rgb=state["rgb"],
        )

    def compute_state(self, request_task_update=True):
        return self._compute_state(request_task_update)

    def _compute_state(self, request_task_update=True):
        """Full state dict: block poses + masks + oracle features + rgb."""
        poses = {
            b: self._backend.block_pose(b) for b in self._backend.block_names
        }
        e_target = np.array(
            self._backend.effector_target_xy(), np.float32
        )

        obs = collections.OrderedDict(
            effector_target_to_start_block_translation=np.array(
                poses[self._start_block][0] - e_target, np.float32
            ),
            start_block_orientation=np.array(
                [poses[self._start_block][1]], np.float32
            ),
        )
        for name, (xy, yaw) in poses.items():
            obs[f"block_{name}_translation"] = np.array(xy, np.float32)
            obs[f"block_{name}_orientation"] = np.array([yaw], np.float32)
            mask = 1.0 if name in self._blocks_on_table else 0.0
            obs[f"block_{name}_mask"] = np.array([mask], np.float32)

        # Long-horizon tasks may switch which block is being pushed;
        # refresh the task info from the reward (reference `:453-466`).
        if (
            request_task_update
            and hasattr(self._reward_calculator, "get_current_task_info")
        ):
            updated = self._reward_calculator.get_current_task_info(obs)
            self._set_task_info(updated)

        self._add_oracle_features(obs, poses, e_target)
        obs["effector_translation"] = np.array(
            self._backend.effector_xy(), np.float32
        )
        obs["effector_target_translation"] = e_target
        obs["instruction"] = self._instruction
        obs["rgb"] = self._render_image()
        return obs

    def _add_oracle_features(self, obs, poses, e_target):
        obs["effector_target_to_start_block_translation"] = np.array(
            poses[self._start_block][0] - e_target, np.float32
        )
        obs["start_block_orientation"] = np.array(
            [poses[self._start_block][1]], np.float32
        )
        if self._oracle_target_translation is not None:
            obs["effector_target_to_task_target_translation"] = np.array(
                self._oracle_target_translation - e_target, np.float32
            )
            obs["task_target_orientation"] = np.array([0.0], np.float32)
        elif self._oracle_target_block is not None:
            obs["effector_target_to_task_target_translation"] = np.array(
                poses[self._oracle_target_block][0] - e_target, np.float32
            )
            obs["task_target_orientation"] = np.array(
                [poses[self._oracle_target_block][1]], np.float32
            )
        else:
            obs["effector_target_to_task_target_translation"] = np.array(
                [0.0, 0.0], np.float32
            )
            obs["task_target_orientation"] = np.array([0.0], np.float32)
        return obs

    def _set_task_info(self, info):
        """Unpack a TaskInfo into start-block / target fields + instruction."""
        self._task_info = info
        self._oracle_target_block = None
        self._oracle_target_translation = None
        self._target_absolute_location = None
        self._target_relative_location = None

        if isinstance(info, task_info.Block2BlockTaskInfo):
            self._start_block = info.block1
            self._oracle_target_block = info.block2
        elif isinstance(info, task_info.Block2LocationTaskInfo):
            self._start_block = info.block
            self._oracle_target_translation = info.target_translation
            self._target_absolute_location = info.location
        elif isinstance(info, task_info.Block2LineTaskInfo):
            self._start_block = info.block
            self._oracle_target_translation = info.target_translation
        elif isinstance(info, task_info.Block2RelativeLocationTaskInfo):
            self._start_block = info.block
            self._target_relative_location = info.location
            self._oracle_target_translation = info.target_translation
        elif isinstance(info, task_info.Block2BlockRelativeLocationTaskInfo):
            self._start_block = info.block
            self._oracle_target_block = info.target_block
            self._target_relative_location = info.direction
            self._oracle_target_translation = info.target_translation
        elif isinstance(info, task_info.SeparateBlocksTaskInfo):
            self._start_block = info.block
            self._oracle_target_translation = info.target_translation
        elif isinstance(info, task_info.Point2BlockTaskInfo):
            self._start_block = info.block_target
            self._oracle_target_block = info.block_target
        elif isinstance(info, task_info.Block2PoleTaskInfo):
            self._start_block = info.block1
            self._oracle_target_block = info.goal
        else:
            raise ValueError(f"Unknown task info: {info}")

        if (
            self._oracle_target_block is None
            and self._oracle_target_translation is None
        ):
            raise ValueError(
                "Reward must provide either a target block or a target "
                "translation for the oracle."
            )
        self._instruction_str = info.instruction
        self._instruction = self.encode_instruction(info.instruction)

    def _reset_poses_randomly(self, blocks_on_table):
        """Rejection-sample a valid board + task (reference `:822-931`)."""
        xmin = constants.X_MIN + constants.WORKSPACE_BOUNDS_BUFFER
        ymin = constants.Y_MIN + constants.WORKSPACE_BOUNDS_BUFFER
        xmax = constants.X_MAX - constants.WORKSPACE_BOUNDS_BUFFER
        ymax = constants.Y_MAX - constants.WORKSPACE_BOUNDS_BUFFER

        # Park every block off-board, then sample the effector start.
        for name in self._backend.block_names:
            self._backend.park_block(name)
        effector_xy = self._rng.uniform(
            low=[xmin, ymin, constants.EFFECTOR_HEIGHT],
            high=[xmax, ymax, constants.EFFECTOR_HEIGHT],
        )[:2]
        self._backend.teleport_effector(effector_xy)
        self._backend.stabilize()

        num_reward_attempts = 0
        max_num_reward_attempts = 20
        while True:
            placed = []
            for name in blocks_on_table:
                attempts = 0
                while True:
                    candidate = self._rng.uniform(
                        low=[xmin, ymin, 0.0], high=[xmax, ymax, 0.0]
                    )
                    yaw = self._rng.uniform(low=0.0, high=2 * np.pi)
                    far_from_blocks = (
                        not placed
                        or min(
                            np.linalg.norm(candidate - p) for p in placed
                        )
                        > constants.BLOCK_DISTANCE_THRESHOLD
                    )
                    far_from_arm = (
                        np.linalg.norm(candidate[:2] - effector_xy)
                        > constants.ARM_DISTANCE_THRESHOLD
                    )
                    if far_from_blocks and far_from_arm:
                        placed.append(candidate)
                        self._backend.set_block_pose(
                            name, candidate[:2], yaw
                        )
                        break
                    attempts += 1
                    if attempts > 20:
                        raise ValueError(
                            "Exceeded max attempts for generating block pose."
                        )
            self._backend.stabilize(nsteps=200)

            if self._reward_calculator is not None:
                self._blocks_on_table = list(blocks_on_table)
                info = self._reward_calculator.reset(
                    self._compute_state(request_task_update=False),
                    blocks_on_table=list(blocks_on_table),
                )
                num_reward_attempts += 1
                if info == task_info.FAILURE:
                    if num_reward_attempts >= max_num_reward_attempts:
                        raise ValueError(
                            "Cannot find a block config with valid reward."
                        )
                    continue
                self._set_task_info(info)
                if self._instruction_str is None:
                    if num_reward_attempts >= max_num_reward_attempts:
                        raise ValueError(
                            "Cannot find a block config with valid reward."
                        )
                    continue
            break
