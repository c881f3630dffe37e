"""Scripted-expert oracles for the Language-Table board.

Parity source: reference `language_table/environments/oracles/` — an
RRT*-planned oriented push oracle used to validate episode inits at eval
time and (originally) to collect demonstration data.
"""

from rt1_tpu_torch.envs.oracles.push_oracle import (
    OrientedPushOracle,
    RRTPushOracle,
)
from rt1_tpu_torch.envs.oracles.rrt_star import plan_shortest_path

__all__ = ["OrientedPushOracle", "RRTPushOracle", "plan_shortest_path"]
