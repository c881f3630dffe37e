"""Reward-family registry and combined instruction enumeration.

Parity source: reference `language_table/environments/rewards/instructions.py`
(aggregate generator + vocab) and the per-family modules.
"""

from rt1_tpu_torch.envs.rewards.base import BoardReward, inside_bounds
from rt1_tpu_torch.envs.rewards.block2block import BlockToBlockReward
from rt1_tpu_torch.envs.rewards.block2block_relative import (
    BlockToBlockRelativeLocationReward,
)
from rt1_tpu_torch.envs.rewards.block2location import BlockToAbsoluteLocationReward
from rt1_tpu_torch.envs.rewards.block2relativelocation import (
    BlockToRelativeLocationReward,
)
from rt1_tpu_torch.envs.rewards.corner import BlockToCornerReward
from rt1_tpu_torch.envs.rewards.play import PlayReward
from rt1_tpu_torch.envs.rewards.point2block import PointToBlockReward
from rt1_tpu_torch.envs.rewards.separate_blocks import SeparateBlocksReward

CLIP_VOCAB_SIZE = 49408

REWARD_FAMILIES = {
    "block2block": BlockToBlockReward,
    "point2block": PointToBlockReward,
    "block2relativelocation": BlockToRelativeLocationReward,
    "block2absolutelocation": BlockToAbsoluteLocationReward,
    "block2block_relative_location": BlockToBlockRelativeLocationReward,
    "separate_blocks": SeparateBlocksReward,
    "block1_to_corner": BlockToCornerReward,
    "play": PlayReward,
}


def get_reward_factory(name):
    return REWARD_FAMILIES[name]


def generate_all_instructions(block_mode):
    """All instructions across the six enumerable families, reference order."""
    from rt1_tpu_torch.envs.rewards import (
        block2block,
        block2block_relative,
        block2location,
        block2relativelocation,
        point2block,
        separate_blocks,
    )

    return (
        block2block.generate_all_instructions(block_mode)
        + point2block.generate_all_instructions(block_mode)
        + block2relativelocation.generate_all_instructions(block_mode)
        + block2location.generate_all_instructions(block_mode)
        + block2block_relative.generate_all_instructions(block_mode)
        + separate_blocks.generate_all_instructions(block_mode)
    )


def generate_runtime_instructions(block_mode):
    """Every instruction the reward SAMPLERS can emit at runtime.

    `generate_all_instructions` mirrors the reference's enumeration, which
    (faithfully) diverges from its own samplers in two ways: canonical
    block names only (samplers draw from the per-board synonym space —
    bare colors/shapes when unique), and 3-verb lists where samplers use
    the generic 4-verb push list (block2location, corner; corner isn't
    enumerated at all). Embedding tables built for closed-loop eval must
    cover the sampler space, so this unions each family's
    `runtime_instructions` (behaviorally pinned by
    `tests/test_env_instructions.py`). The play family's BLOCK_8 generator
    is open-ended and excluded; its fixed BLOCK_4 set is included.
    """
    from rt1_tpu_torch.envs import blocks
    from rt1_tpu_torch.envs.rewards import (
        block2block,
        block2block_relative,
        block2location,
        block2relativelocation,
        corner,
        play,
        point2block,
        separate_blocks,
    )

    out = list(generate_all_instructions(block_mode))
    seen = set(out)

    def extend(items):
        for s in items:
            if s not in seen:
                seen.add(s)
                out.append(s)

    for family in (
        block2block,
        point2block,
        block2relativelocation,
        block2location,
        block2block_relative,
        separate_blocks,
        corner,
    ):
        extend(family.runtime_instructions(block_mode))
    if block_mode == blocks.BlockMode.BLOCK_4:
        # Same split constant as PlayReward's sampler — never hardcode a
        # number here (a mismatch silently uncovers play instructions).
        extend(
            play.get_100_4block_instructions(
                num_train_per_family=play.NUM_TRAIN_PER_FAMILY
            )
        )
    return out


def vocab_size(block_mode):
    words = set()
    for instruction in generate_all_instructions(block_mode):
        words.update(instruction.split(" "))
    return len(words)


__all__ = [
    "BoardReward",
    "inside_bounds",
    "BlockToBlockReward",
    "PointToBlockReward",
    "BlockToRelativeLocationReward",
    "BlockToAbsoluteLocationReward",
    "BlockToBlockRelativeLocationReward",
    "SeparateBlocksReward",
    "BlockToCornerReward",
    "PlayReward",
    "REWARD_FAMILIES",
    "get_reward_factory",
    "generate_all_instructions",
    "vocab_size",
    "CLIP_VOCAB_SIZE",
]
