"""Instruction-grammar vocabulary shared across reward families.

Parity source: reference `language_table/environments/rewards/synonyms.py`.
The string tables are data and must match the reference exactly — instruction
counts (tests/test_env_instructions.py) and any text-conditioned policy depend
on the literal strings.
"""

import collections

from rt1_tpu_torch.envs import blocks as blocks_module

PUSH_VERBS = [
    "push the",
    "move the",
    "slide the",
    "put the",
]

PREPOSITIONS = [
    "to the",
    "towards the",
    "close to the",
    "next to the",
]

POINT_PREPOSITIONS = [
    "point next to the",
    "point close to the",
    "point to the",
    "point at the",
    "move the arm next to the",
    "move the arm close to the",
    "move the arm to the",
    "move your arm next to the",
    "move your arm close to the",
    "move your arm to the",
    "move next to the",
    "move close to the",
    "move to the",
]


def block_synonyms(block, blocks_on_table):
    """Ways to refer to `block` unambiguously given the current board.

    A bare color ('red block') or bare shape ('star') is only valid when it
    is unique on the table; 'color shape' is always valid
    (reference `synonyms.py:20-35`).
    """
    color, shape = blocks_module.color_shape(block)
    colors = collections.Counter(
        blocks_module.color_shape(b)[0] for b in blocks_on_table
    )
    shapes = collections.Counter(
        blocks_module.color_shape(b)[1] for b in blocks_on_table
    )
    names = []
    if colors[color] == 1:
        names.append(f"{color} block")
    if shapes[shape] == 1:
        names.append(shape)
    names.append(f"{color} {shape}")
    return names
