"""Continuous deployment: eval-gated promotion, weighted canary,
SLO-burn auto-rollback.

The port's copy of `rt1_tpu/deploy/` (the port imports nothing of the JAX
package); it keeps the JAX package's names, flags, files and metric
families.

The repo's last human-in-the-loop step: training writes checkpoints,
serving hot-swaps them, the eval matrix judges them — but a person still
glues those together. This package closes the collect -> train ->
**deploy** -> serve loop:

* `watcher`   — torn-write-tolerant checkpoint discovery on a train
                workdir (the candidate source).
* `decision`  — the pure burn-window/hysteresis judge: canary signals
                in, hold | promote | rollback out.
* `verdict`   — signed promotion-verdict artifacts (HMAC over canonical
                JSON) so "who approved this checkpoint" is evidence,
                not a log line.
* `gate`      — the offline promotion gate: eval-matrix cells vs. the
                incumbent + the serve parity check (torch, imported
                lazily; the engines run on the fleet's --device).
* `controller`— the PromotionController state machine driving the fleet
                router: gate -> canary one replica at a weighted
                fraction of fresh sessions -> watch per-replica burn ->
                promote fleet-wide (rolling reload) or auto-roll-back.

Everything except `gate` is import-light (stdlib only): the controller
runs inside the fleet supervisor process, which imports no torch unless
a real gate runs (`tests/test_torch_imports.py` checks the stdlib ones).
"""

from rt1_tpu_torch.deploy.decision import (  # noqa: F401
    CanaryJudge,
    CanaryPolicy,
    CanarySignals,
)
from rt1_tpu_torch.deploy.watcher import (  # noqa: F401
    CheckpointWatcher,
    latest_checkpoint_step,
)
