"""Task-description records returned by reward `reset()`.

Parity source: reference `language_table/environments/rewards/task_info.py`.
`FAILURE` is the sentinel a reward returns when it cannot construct a valid
task from the current board, prompting the env to re-randomize.
"""

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Block2BlockTaskInfo:
    instruction: str
    block1: str
    block2: str


@dataclasses.dataclass
class Block2LocationTaskInfo:
    instruction: str
    block: str
    target_translation: np.ndarray
    location: str


@dataclasses.dataclass
class Block2LineTaskInfo:
    instruction: str
    block: str
    target_translation: np.ndarray


@dataclasses.dataclass
class Block2PoleTaskInfo:
    instruction: str
    block1: str
    goal: str


@dataclasses.dataclass
class Block2RelativeLocationTaskInfo:
    instruction: str
    block: str
    target_translation: np.ndarray
    location: str


@dataclasses.dataclass
class Block2BlockRelativeLocationTaskInfo:
    instruction: str
    block: str
    target_block: str
    direction: str
    target_translation: np.ndarray


@dataclasses.dataclass
class SeparateBlocksTaskInfo:
    instruction: str
    block: str
    avoid_blocks: List[str]
    target_translation: np.ndarray


@dataclasses.dataclass
class Point2BlockTaskInfo:
    instruction: str
    block_target: str


ALL_TASKS = [
    Block2BlockTaskInfo,
    Block2LocationTaskInfo,
    Block2RelativeLocationTaskInfo,
    Block2BlockRelativeLocationTaskInfo,
    SeparateBlocksTaskInfo,
    Point2BlockTaskInfo,
    Block2LineTaskInfo,
    Block2PoleTaskInfo,
]

FAILURE = "failure"
