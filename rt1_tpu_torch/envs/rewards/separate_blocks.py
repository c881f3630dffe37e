"""'Separate block X from the other blocks' task.

Parity source: reference
`language_table/environments/rewards/separate_blocks.py`.
"""

import numpy as np

from rt1_tpu_torch.envs import blocks as blocks_module
from rt1_tpu_torch.envs import task_info
from rt1_tpu_torch.envs.rewards import base

# Blocks need "separating" when at least this close together.
CONSIDERED_JOINED_THRESHOLD = 0.08
# How far past the avoid-centroid to push.
MAGNITUDE = 0.1
# Solved when within this distance of the invisible target.
DISTANCE_TO_TARGET_THRESHOLD = 0.025

SEPARATE_TEMPLATES = [
    "pull the %s apart from the %s",
    "move the %s away from the %s",
    "separate the %s from the %s",
]

GROUP_SYNONYMS = ["group", "clump", "group of blocks"]
REST = "rest of the blocks"


def _avoid_phrase(avoid_syns, n_on_table, group_syn, rng=None):
    """Render the list of blocks to move away from as one phrase.

    Mirrors the reference's cascading-if rendering
    (`separate_blocks.py:52-69,113-127`) including its quirk that the REST
    ("rest of the blocks") assignment is always overridden by a later
    branch (len 1-3 or >= 4 cover every case), so REST never actually
    appears in generated instructions — behavioral parity over intent.
    """
    phrase = None
    if len(avoid_syns) == n_on_table - 1:
        phrase = REST
    if len(avoid_syns) == 1:
        phrase = avoid_syns[0]
    if len(avoid_syns) == 2:
        phrase = "%s and %s" % tuple(avoid_syns)
    if len(avoid_syns) == 3:
        specific = "%s, %s, and %s" % tuple(avoid_syns)
        if rng is None:
            phrase = specific
        else:
            phrase = rng.choice([specific, group_syn])
    if len(avoid_syns) >= 4:
        phrase = group_syn
    return phrase


def generate_all_instructions(block_mode):
    out = []
    names = blocks_module.text_descriptions(block_mode)
    for block_syn in names:
        for idx in range(1, len(names)):
            avoid_syns = names[:idx]
            for group_syn in GROUP_SYNONYMS:
                avoid_str = _avoid_phrase(avoid_syns, len(names), group_syn)
                for template in SEPARATE_TEMPLATES:
                    out.append(template % (block_syn, avoid_str))
    return out


def runtime_instructions(block_mode):
    """Sampler-complete: avoid-lists are ordered tuples of OTHER blocks'
    synonyms (sizes 1-3 rendered explicitly, 3 may also use a group
    synonym, >= 4 always does) — the parity enumeration's name-prefix
    orderings cover only a sliver of this. Quadratic-ish in board size;
    intended for the BLOCK_4/BLOCK_8 table configs (N_CHOOSE_K's space is
    astronomically large — use a string-level embedder there).
    """
    import itertools

    groups = blocks_module.synonym_groups(block_mode)
    out = []
    for i, g in enumerate(groups):
        others = [g2 for j, g2 in enumerate(groups) if j != i]
        avoid_strs = list(GROUP_SYNONYMS)  # len 3 group branch and >= 4
        for g2 in others:
            avoid_strs.extend(g2)  # len 1
        for ga, gb in itertools.permutations(others, 2):  # len 2, ordered
            avoid_strs.extend(
                f"{a} and {b}" for a in ga for b in gb
            )
        for ga, gb, gc in itertools.permutations(others, 3):  # len 3
            avoid_strs.extend(
                f"{a}, {b}, and {c}"
                for a in ga
                for b in gb
                for c in gc
            )
        for block_syn in g:
            for avoid_str in avoid_strs:
                for template in SEPARATE_TEMPLATES:
                    out.append(template % (block_syn, avoid_str))
    return out


class SeparateBlocksReward(base.BoardReward):
    """Push the most-crowded block away from its neighbors."""

    def __init__(self, goal_reward, rng, delay_reward_steps, block_mode):
        super().__init__(goal_reward, rng, delay_reward_steps, block_mode)
        self._instruction = None
        self._block = None
        self._avoid_blocks = None
        self._target_translation = None
        self._avoid_centroid_xy = None

    def get_current_task_info(self, state):
        if self._block is None:
            raise ValueError("must call .reset first")
        self._target_translation = self.target_translation_for(
            state, self._block, self._avoid_blocks
        )
        return task_info.SeparateBlocksTaskInfo(
            instruction=self._instruction,
            block=self._block,
            avoid_blocks=self._avoid_blocks,
            target_translation=self._target_translation,
        )

    def _sample_instruction(self, block, avoid_blocks, blocks_on_table):
        block_syn = self._pick_synonym(block, blocks_on_table)
        avoid_syns = [
            self._pick_synonym(b, blocks_on_table) for b in avoid_blocks
        ]
        group_syn = self._rng.choice(GROUP_SYNONYMS)
        avoid_str = _avoid_phrase(
            avoid_syns, len(blocks_on_table), group_syn, rng=self._rng
        )
        template = self._rng.choice(SEPARATE_TEMPLATES)
        return template % (block_syn, avoid_str)

    def _closest_blocks(self, block, block_xy, all_xy):
        dists = sorted(
            (
                (name, np.linalg.norm(block_xy - xy))
                for name, xy in all_xy
                if name != block
            ),
            key=lambda kv: kv[1],
        )
        joined = [kv for kv in dists if kv[1] < CONSIDERED_JOINED_THRESHOLD]
        if not joined:
            return [], np.inf
        return [kv[0] for kv in joined], float(
            np.mean([kv[1] for kv in joined])
        )

    def _blocks_to_separate(self, state, blocks_on_table):
        all_xy = [(b, self._block_xy(b, state)) for b in blocks_on_table]
        xy_of = dict(all_xy)
        candidates = sorted(
            (
                (b, self._closest_blocks(b, xy_of[b], all_xy))
                for b in xy_of
            ),
            key=lambda kv: kv[1][1],
        )
        push_block, (avoid_blocks, avg_dist) = candidates[0]
        return push_block, avoid_blocks, avg_dist

    def _avoid_direction(self, state, push_block, avoid_blocks):
        push_xy = self._block_xy(push_block, state)
        centroid = np.mean(
            [self._block_xy(b, state) for b in avoid_blocks], axis=0
        )
        self._avoid_centroid_xy = centroid
        to_centroid = centroid - push_xy
        to_centroid = to_centroid / (
            np.linalg.norm(to_centroid) + np.finfo(np.float32).eps
        )
        return -to_centroid

    def target_translation_for(self, state, block, avoid_blocks):
        direction = self._avoid_direction(state, block, avoid_blocks)
        return self._avoid_centroid_xy + direction * MAGNITUDE

    def reset(self, state, blocks_on_table):
        tries = 0
        while True:
            push_block, avoid_blocks, _ = self._blocks_to_separate(
                state, blocks_on_table
            )
            if not avoid_blocks:
                # Everything already far apart: no valid task on this board.
                return task_info.FAILURE
            target = self.target_translation_for(
                state, push_block, avoid_blocks
            )
            if base.inside_bounds(target):
                break
            tries += 1
            if tries > 100:
                return task_info.FAILURE
        return self.reset_to(state, push_block, avoid_blocks, blocks_on_table)

    def reset_to(self, state, block, avoid_blocks, blocks_on_table):
        self._block = block
        self._avoid_blocks = avoid_blocks
        self._target_translation = self.target_translation_for(
            state, block, avoid_blocks
        )
        self._instruction = self._sample_instruction(
            block, avoid_blocks, blocks_on_table
        )
        self._in_reward_zone_steps = 0
        return self.get_current_task_info(state)

    @property
    def target_translation(self):
        return self._target_translation

    def reward(self, state):
        return self.reward_for(state, self._block, self._target_translation)

    def reward_for(self, state, push_block, target_translation):
        dist = np.linalg.norm(
            self._block_xy(push_block, state) - target_translation
        )
        return self._maybe_goal(dist < DISTANCE_TO_TARGET_THRESHOLD)

    def reward_for_info(self, state, info):
        return self.reward_for(
            state, push_block=info.block,
            target_translation=info.target_translation,
        )

    def debug_info(self, state):
        return np.linalg.norm(
            self._block_xy(self._block, state) - self._target_translation
        )
