"""The training data path (counterpart of `rt1_tpu/data/`).

* `episodes` — the episode record and its `.npz` file, the reference's
  pickled `.npy` reader, synthetic episodes, `write_manifest`,
  `read_manifest`, `check_embedder_compatibility`.
* `native` — the window sampler (`native/window_sampler.cc`), compiled
  with g++ at first use and bound with ctypes: crop + fixed-point bilinear
  resize, and the packed-frame gather.
* `pipeline` — `WindowedEpisodeDataset` (the index of windows, the LRU of
  episodes, `numpy_batches`, `as_torch_loader`) and `device_feeder`, which
  moves host batches to the card through pinned memory on a copy stream.
* `pack` — the packed mmap frame cache (the JAX package's on-disk format,
  byte for byte) and `PackedEpisodeCache`.
* `feeder` — `SampleAheadFeeder`, background batch assembly over the
  packed cache.
* `pack_dataset` — `python -m rt1_tpu_torch.data.pack_dataset`, the
  offline packer.
* `collect` — oracle demos (DART noise optional) from the simulator, over
  worker processes; `python -m rt1_tpu_torch.data.collect`.
* `dagger` — on-policy rollouts relabelled by the oracle, aggregated into
  a corpus.
* `normalization` — dataset statistics (Chan's parallel algorithm).
"""
