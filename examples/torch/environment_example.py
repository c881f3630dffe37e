"""Random-action rollout on the Language-Table env and a rendered frame,
on `rt1_tpu_torch` (the port's counterpart of `examples/environment_example.py`).

The board runs on the numpy kinematic backend (no PyBullet); the frame is
drawn by the port's numpy renderer and written as a one-frame GIF by
`rt1_tpu_torch.eval.video` (the port needs no PIL).

Run: python examples/torch/environment_example.py [--out /tmp/language_table_frame.gif]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

import numpy as np

from rt1_tpu_torch.envs import LanguageTable, blocks
from rt1_tpu_torch.envs.rewards import BlockToBlockReward
from rt1_tpu_torch.eval.video import write_gif


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "language_table_frame.gif"))
    args = p.parse_args(argv)
    env = LanguageTable(
        block_mode=blocks.BlockMode.BLOCK_8,
        reward_factory=BlockToBlockReward,
        seed=0,
    )
    obs = env.reset()
    print("instruction:", env.instruction_str)
    rng = np.random.RandomState(0)
    for t in range(20):
        action = rng.uniform(-0.03, 0.03, 2)
        obs, reward, done, _ = env.step(action)
        if done:
            break
    frame = env.render()
    print("final frame:", frame.shape, "reward:", reward, "done:", done)
    print("wrote", write_gif(args.out, [frame]))


if __name__ == "__main__":
    main()
