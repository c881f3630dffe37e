"""Block-set definitions for the Language-Table board.

Parity source: reference `language_table/environments/blocks.py:24-160`.
The N_CHOOSE_K train/test split must reproduce the reference's seeded shuffle
(`blocks.py:120-129`) bit-for-bit so dataset/eval splits line up.
"""

import collections
import enum
import itertools

import numpy as np


class BlockMode(enum.Enum):
    """Which set of blocks is on the table."""

    BLOCK_1 = "BLOCK_1"  # single green star (debug)
    BLOCK_4 = "BLOCK_4"  # the original 4-block board
    BLOCK_8 = "BLOCK_8"  # 2 of each color / 2 of each shape
    BLOCK_4_WPOLE = "BLOCK_4_WPOLE"  # 4 blocks + purple goal pole
    BLOCK_8_WPOLE = "BLOCK_8_WPOLE"  # 8 blocks + purple goal pole
    N_CHOOSE_K = "N_CHOOSE_K"  # combinatorial 4..10 of the 16 blocks


BLOCK_MODES = [m.value for m in BlockMode]

COLORS = ("red", "blue", "green", "yellow")
SHAPES = ("moon", "cube", "star", "pentagon")
ALL_BLOCKS = ["_".join(p) for p in itertools.product(COLORS, SHAPES)]

FIXED_1 = ["green_star"]
FIXED_4 = ("red_moon", "blue_cube", "green_star", "yellow_pentagon")
FIXED_8 = (
    "red_moon",
    "red_pentagon",
    "blue_moon",
    "blue_cube",
    "green_cube",
    "green_star",
    "yellow_star",
    "yellow_pentagon",
)
POLE = "purple_pole"
FIXED_4_WPOLE = FIXED_4 + (POLE,)
FIXED_8_WPOLE = FIXED_8 + (POLE,)


def _n_choose_k_combinations():
    """All 4..10-of-16 block subsets, seeded-shuffled then split 90/10.

    Mirrors the reference's module-level construction
    (`blocks.py:118-129`): numpy RandomState(0) in-place shuffle of the
    full combination list, first 90% train.
    """
    combos = []
    for k in range(4, 11):
        combos.extend(itertools.combinations(ALL_BLOCKS, k))
    rng = np.random.RandomState(seed=0)
    rng.shuffle(combos)
    split = int(len(combos) * 0.9)
    return combos[:split], combos[split:]


TRAIN_COMBINATIONS, TEST_COMBINATIONS = _n_choose_k_combinations()


def block_set(mode):
    """The unique block universe for a mode (used for obs-space keys)."""
    mode = BlockMode(mode)
    if mode == BlockMode.BLOCK_1:
        return FIXED_1
    if mode == BlockMode.BLOCK_4:
        return FIXED_4
    if mode == BlockMode.BLOCK_8:
        return FIXED_8
    if mode == BlockMode.N_CHOOSE_K:
        return ALL_BLOCKS
    if mode == BlockMode.BLOCK_4_WPOLE:
        return FIXED_4_WPOLE
    if mode == BlockMode.BLOCK_8_WPOLE:
        return FIXED_8_WPOLE
    raise ValueError(f"Unsupported block mode: {mode}")


def block_subsets(mode, training):
    """All block subsets the env may sample a board from."""
    mode = BlockMode(mode)
    if mode == BlockMode.N_CHOOSE_K:
        return TRAIN_COMBINATIONS if training else TEST_COMBINATIONS
    return [block_set(mode)]


def text_descriptions(mode):
    """Human-readable names, e.g. 'red_moon' -> 'red moon'."""
    return [b.replace("_", " ") for b in block_set(mode)]


def block_pairs(mode):
    """All ordered pairs of distinct blocks (for instruction enumeration)."""
    return itertools.permutations(block_set(mode), 2)


def synonym_groups(mode):
    """Per-block referring-expression variants, unioned over board states.

    `language.block_synonyms` admits a bare color ('red block') or bare
    shape ('star') only when unique on the current board; this returns, per
    block, every variant that is valid on SOME reachable board of `mode`.
    Fixed boards (BLOCK_4/8, ±pole) always show the full set, so a bare
    form is reachable iff the color/shape is unique in the set — which
    includes e.g. the pole on BLOCK_8_WPOLE. N_CHOOSE_K boards are
    subsets, so any bare form can become unique. Order matches
    block_synonyms (color, shape, canonical).
    """
    names = block_set(mode)
    color_counts = collections.Counter(color_shape(b)[0] for b in names)
    shape_counts = collections.Counter(color_shape(b)[1] for b in names)
    any_subset = mode == BlockMode.N_CHOOSE_K
    groups = []
    for b in names:
        color, shape = color_shape(b)
        variants = []
        if any_subset or color_counts[color] == 1:
            variants.append(f"{color} block")
        if any_subset or shape_counts[shape] == 1:
            variants.append(shape)
        variants.append(f"{color} {shape}")
        groups.append(variants)
    return groups


def color_shape(block):
    color, shape = block.split("_")
    return color, shape
