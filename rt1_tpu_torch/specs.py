"""Action space specs (counterpart of `rt1_tpu/specs.py`).

Frozen, hashable dataclasses carrying the same information as the
reference's `gym.spaces` entries. `sample_spec` stays in the JAX package:
the port's tests make their inputs with numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class DiscreteSpec:
    """A categorical value in [0, n). Mirrors `gym.spaces.Discrete(n)`."""

    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class BoxSpec:
    """A bounded continuous vector. Mirrors 1-D `gym.spaces.Box`."""

    low: Tuple[float, ...]
    high: Tuple[float, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        size = int(np.prod(self.shape)) if self.shape else 1
        if len(self.low) not in (1, size):
            raise ValueError(f"low {self.low} not broadcastable to {self.shape}")
        if len(self.high) not in (1, size):
            raise ValueError(f"high {self.high} not broadcastable to {self.shape}")

    def low_array(self) -> np.ndarray:
        return np.broadcast_to(np.asarray(self.low, np.float32), self.shape)

    def high_array(self) -> np.ndarray:
        return np.broadcast_to(np.asarray(self.high, np.float32), self.shape)


Spec = Union[DiscreteSpec, BoxSpec]


def language_table_action_space() -> Dict[str, Spec]:
    # Order matters for tokenization: terminate_episode then the 2-d action,
    # so tokens_per_action == 3.
    return {
        "terminate_episode": DiscreteSpec(2),
        "action": BoxSpec(low=(-0.1,), high=(0.1,), shape=(2,)),
    }
