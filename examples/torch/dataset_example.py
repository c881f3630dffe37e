"""Collect a tiny oracle dataset and iterate training batches, on
`rt1_tpu_torch` (the port's counterpart of `examples/dataset_example.py`).

The scripted RRT oracle generates the data (no external dataset), and the
windowed loader turns it into batches of torch tensors, as the trainer's
`data.loader=torch` takes them.

Run: python examples/torch/dataset_example.py [--data_dir /tmp/lt_example_data_torch]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

import glob

from rt1_tpu_torch.data.collect import collect_dataset
from rt1_tpu_torch.data.pipeline import WindowedEpisodeDataset
from rt1_tpu_torch.envs import blocks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_dir", default=os.path.join(tempfile.gettempdir(),
                                                      "lt_example_data_torch"))
    p.add_argument("--episodes", type=int, default=4)
    args = p.parse_args(argv)
    data_dir = args.data_dir
    if not glob.glob(os.path.join(data_dir, "train", "episode_*.npz")):
        print(f"collecting {args.episodes} oracle episodes...")
        collect_dataset(
            data_dir,
            args.episodes,
            block_mode=blocks.BlockMode.BLOCK_4,
            seed=0,
            max_steps=120,
            image_hw=(90, 160),
            splits=(("train", 1.0),),
        )

    paths = sorted(glob.glob(os.path.join(data_dir, "train", "episode_*.npz")))
    ds = WindowedEpisodeDataset(
        paths, window=6, crop_factor=0.95, height=128, width=228
    )
    print(f"{len(paths)} episodes, {len(ds)} windows")

    loader = ds.as_torch_loader(batch_size=4, num_workers=0)
    batch = next(iter(loader))
    for group, tree in batch.items():
        for key, tensor in tree.items():
            print(f"{group}/{key}: {tuple(tensor.shape)} {tensor.dtype}")


if __name__ == "__main__":
    main()
