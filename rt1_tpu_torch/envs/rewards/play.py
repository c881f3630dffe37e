"""Long-horizon 'play' instruction families (no scripted reward).

Parity source: reference `language_table/environments/rewards/play.py`.
Instruction text is data and matches the reference's grammar exactly; the
reward is always 0 (these tasks are scored by humans / learned models).
"""

import itertools
import random

import numpy as np

from rt1_tpu_torch.envs import constants, task_info
from rt1_tpu_torch.envs.rewards import base

BLOCKS4 = ["red moon", "blue cube", "green star", "yellow pentagon"]
BLOCKS8 = [
    "red moon", "red pentagon", "blue moon", "blue cube", "green cube",
    "green star", "yellow star", "yellow pentagon",
]
LOCATIONS = [
    "top left corner", "top center", "top right corner", "center left",
    "center", "center right", "bottom left corner", "bottom center",
    "bottom right corner",
]
COLORS = ["red", "blue", "green", "yellow"]
ORDERINGS = list(itertools.permutations(BLOCKS4))


def obj_in_place_then_remainder_in_other(blocks, locations):
    return [
        f"put the {b} in the {l0}, then put the rest of the blocks in the {l1}"
        for b in blocks
        for l0 in locations
        for l1 in locations
        if l0 != l1
    ]


def k_in_place_then_k_minus_1_in_other(blocks, locations):
    numbers = ["one", "two", "three", "four", "five", "six", "seven", "eight"]
    out = []
    for number in numbers[: len(blocks)][:-1]:
        noun = "block" if number == "one" else "blocks"
        for l0 in locations:
            for l1 in locations:
                if l0 != l1:
                    out.append(
                        f"put {number} {noun} in the {l0}, "
                        f"then put the rest in the {l1}"
                    )
    return out


def triangle_in_place_remainder_in_rest(locations):
    return [
        (
            "make a triangle out of three blocks and put it in the "
            f"{l0} of the board, then put the remainder in the {l1} of the board"
        )
        for l0 in locations
        for l1 in locations
        if l0 != l1
    ]


def order_by(orderings):
    return [
        "order the blocks from %s: %s" % (orientation, ", ".join(ordering))
        for orientation in ["top to bottom", "left to right"]
        for ordering in orderings
    ]


def _expand(seeded):
    out = []
    for seed, expansions in seeded:
        if expansions is None:
            out.append(seed)
        else:
            out.extend(seed % e for e in expansions)
    return out


# The train-split size per long-horizon family. Single source of truth for
# BOTH the sampler (PlayReward below) and the runtime embedding table
# (rewards.generate_runtime_instructions): if the two disagreed, a table
# embedder would silently miss play instructions at reset and the policy
# would get a stale/KeyError embedding mid-eval.
NUM_TRAIN_PER_FAMILY = 20


def get_100_4block_instructions(num_train_per_family=NUM_TRAIN_PER_FAMILY,
                                num_test_per_family=5,
                                return_train=True):
    """20 random train (+5 test) instructions per long-horizon family."""
    train_inst, test_inst = [], []
    # Local RNG seeded like the reference's `random.seed(0)` (play.py:110)
    # without the side effect of reseeding the process-global random module.
    rng = random.Random(0)

    def take(family):
        rng.shuffle(family)
        if num_train_per_family:
            train_inst.extend(family[:num_train_per_family])
            test_inst.extend(
                family[
                    num_train_per_family:
                    num_train_per_family + num_test_per_family
                ]
            )
        else:
            train_inst.extend(family)

    take(_expand([
        ("put all the blocks in a line", None),
        ("put all the blocks in a %s line", ["horizontal", "vertical"]),
        ("put all the blocks in a vertical line on the %s side of the board",
         ["left", "center", "right"]),
        ("put all the blocks in a horizontal line on the %s side of the board",
         ["bottom", "center", "top"]),
        ("put the blocks in a diagonal line from the %s",
         ["top left to bottom right", "top right to bottom left"]),
        ("surround the %s with the other blocks", BLOCKS4),
        ("put all the blocks in the %s", LOCATIONS),
        ("put blocks in all four corners", None),
        ("make a %s shape out of the blocks",
         ["rectangle", "square", "diamond", "parallelogram"]),
    ]))
    take(obj_in_place_then_remainder_in_other(BLOCKS4, LOCATIONS))
    take(k_in_place_then_k_minus_1_in_other(BLOCKS4, LOCATIONS))
    take(triangle_in_place_remainder_in_rest(LOCATIONS))
    take(order_by(ORDERINGS))
    return train_inst if return_train else test_inst


def unique_color_combos():
    combos = list(itertools.combinations(COLORS, 2))
    out = []
    for ci, cj in combos:
        complement = [
            (a, b) for a, b in combos if ci not in (a, b) and cj not in (a, b)
        ]
        out.append((ci, cj, complement[0][0], complement[0][1]))
    return out


def colors_in_locations():
    out = []
    for colors, locations in itertools.product(
        itertools.permutations(COLORS, 4), itertools.permutations(LOCATIONS, 4)
    ):
        inst = (
            f"put the {colors[0]} blocks in the {locations[0]}, "
            f"the {colors[1]} blocks in the {locations[1]}, "
            f"the {colors[2]} blocks in the {locations[2]}, "
            f"and the {colors[3]} blocks in the {locations[3]}."
        )
        if len(inst) > 256:
            raise ValueError(f"Instruction greater than max length: {inst}")
        out.append(inst)
    return out


def group_color_pairs():
    return [
        (
            f"put the {ci} and {cj} blocks together in a group, then put the "
            f"{ck} and {cl} blocks together in a group."
        )
        for ci, cj, ck, cl in itertools.permutations(COLORS, 4)
    ]


def group_color_pairs_in_locations():
    return [
        (
            f"put the {ci} and {cj} blocks together in the {li}, then put the "
            f"{ck} and {cl} blocks together in the {lj}."
        )
        for ci, cj, ck, cl in unique_color_combos()
        for li, lj in itertools.permutations(LOCATIONS, 2)
    ]


def get_colors_in_lines():
    return [
        (
            f"make one {mi} line out of the {ci} and {cj} blocks, then "
            f"make a {mj} line out of the {ck} and {cl} blocks"
        )
        for mi in ["horizontal", "vertical"]
        for mj in ["horizontal", "vertical"]
        for ci, cj, ck, cl in unique_color_combos()
    ]


def get_line_tasks():
    tasks = [
        "put the blocks in a line",
        "put all the blocks in a vertical line",
        "put all the blocks in a horizontal line",
    ]
    tasks += [
        f"put all the blocks in a vertical line on the {m} of the board"
        for m in ["left", "center", "right"]
    ]
    tasks += [
        f"put all the blocks in a horizontal line on the {m} of the board"
        for m in ["bottom", "center", "top"]
    ]
    tasks += [
        f"put the blocks in a diagonal line from the {m}"
        for m in ["top left to bottom right", "top right to bottom left"]
    ]
    return tasks


def get_surround_tasks():
    return [f"surround the {b} with the others" for b in BLOCKS8]


def blocks_in_order_outer_edge():
    outer = [
        "top left", "top center", "top right", "center left", "center right",
        "bottom left", "bottom center", "bottom right",
    ]
    out = []
    for ordering in itertools.permutations(BLOCKS8, len(BLOCKS8)):
        inst = "put the " + "".join(
            f"{b} to {l}, " for b, l in zip(ordering, outer)
        )
        if len(inst) > 256:
            raise ValueError(f"Instruction greater than max length: {inst}")
        out.append(inst)
    return out


def all_blocks_in_location():
    return [f"put all the blocks in the {l}" for l in LOCATIONS]


def k_blocks_in_location_i_rest_in_location_j():
    return [
        f"put {k} blocks in the {li}, then the rest in the {lj}"
        for k in range(1, 8)
        for li, lj in itertools.permutations(LOCATIONS, 2)
    ]


def get_shape_instructions():
    shapes = [
        "square", "triangle", "circle", "diamond", "parallelogram", "G", "O",
        "L", "E", "A", "T", "X", "V", "Y", "U", "S", "C", "Z", "N", "J",
    ]
    out = [f'make a "{shape}"" shape out of all the blocks' for shape in shapes]
    out.append("make a smiley face out of the blocks")
    out.append(
        "make a rainbow out of the blocks (red, yellow, green, "
        "blue in a semicircle)"
    )
    return out


def get_sort_tasks():
    return ["group the blocks by color"]


_FAMILY_CACHE = {}


def _cached_family(fn):
    """Families like colors_in_locations build 10k-70k strings; build once."""
    if fn not in _FAMILY_CACHE:
        _FAMILY_CACHE[fn] = fn()
    return _FAMILY_CACHE[fn]


def get_random_8block_instruction(rng):
    task_fns = [
        get_sort_tasks, colors_in_locations, group_color_pairs,
        get_colors_in_lines, group_color_pairs_in_locations, get_line_tasks,
        get_surround_tasks, blocks_in_order_outer_edge,
        all_blocks_in_location, k_blocks_in_location_i_rest_in_location_j,
        get_shape_instructions,
    ]
    return rng.choice(_cached_family(rng.choice(task_fns)))


class PlayReward(base.BoardReward):
    """Long-horizon instruction sampler; never emits reward."""

    def __init__(self, goal_reward, rng, delay_reward_steps, block_mode):
        super().__init__(goal_reward, rng, delay_reward_steps, block_mode)
        self.block_mode = block_mode.value
        if self.block_mode == "BLOCK_4":
            self._all_instructions = get_100_4block_instructions(
                num_train_per_family=NUM_TRAIN_PER_FAMILY
            )

    def _sample_instruction(self, start_block, target_block, blocks_on_table):
        if self.block_mode == "BLOCK_4":
            return self._rng.choice(self._all_instructions)
        if self.block_mode == "BLOCK_8":
            return get_random_8block_instruction(self._rng)
        raise ValueError(f"Unsupported block mode: {self.block_mode}")

    def reset(self, state, blocks_on_table):
        attempts = 0
        while True:
            start_block, target_block = self._pick_two_blocks(blocks_on_table)
            dist = np.linalg.norm(
                self._block_xy(start_block, state)
                - self._block_xy(target_block, state)
            )
            if dist < constants.TARGET_BLOCK_DISTANCE + 0.01:
                attempts += 1
                if attempts > 10:
                    return task_info.FAILURE
                continue
            break
        self._start_block = start_block
        self._target_block = target_block
        self._instruction = self._sample_instruction(
            start_block, target_block, blocks_on_table
        )
        self._in_reward_zone_steps = 0
        return task_info.Block2BlockTaskInfo(
            instruction=self._instruction,
            block1=self._start_block,
            block2=self._target_block,
        )

    def reward(self, state):
        return 0.0, False
