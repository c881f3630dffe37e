"""rt1_tpu_torch.flywheel — serve traffic back into the training corpus.

The port's copy of `rt1_tpu/flywheel/` (the port imports nothing of the JAX
package). The data flywheel closes the collect -> train -> serve loop:
served sessions are the corpus.

* :mod:`rt1_tpu_torch.flywheel.capture` — the serve-side episode-capture sink:
  an opt-in, bounded ring of completed sessions written as standard
  episode `.npz` files (`data/episodes.py` schema), plus the
  fleet sweep that funnels per-replica capture dirs into one staging dir.
* `data/pack.py::append_shard` — turns a staging dir into a new
  pack shard with an atomically bumped `freshness_epoch`.
* `data/feeder.py::SampleAheadFeeder(refresh_at_epoch=True)` —
  a running train job picks the new shard up at the next epoch boundary,
  no restart.

Import hygiene matches `rt1_tpu_torch.obs`: stdlib + numpy only at module
scope — the capture sink runs inside serve replicas and the sweep inside
the torch-free fleet supervisor.
"""

from rt1_tpu_torch.flywheel.capture import EpisodeCaptureSink, sweep_captures

__all__ = ["EpisodeCaptureSink", "sweep_captures"]
