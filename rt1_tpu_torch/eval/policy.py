"""The closed-loop RT-1 eval policy (counterpart of `rt1_tpu/eval/policy.py`).

`RT1EvalPolicy` is a one-slot wrapper over the port's serving engine
(`serve/engine.py::PolicyEngine`), as the JAX package's is over its own:
it feeds the LAST frame of the history-stacked observation, keeps the
rolling network state on the device across steps, and de-normalises and
clips the decoded action in the engine (parity source: reference
`language_table/train/policy.py:32-112`, `BCJaxPyPolicyRT1`). One control
step is one `RT1Policy.infer_step`; with fused attention on the card it
launches the attention kernel once per decoder layer.

The LAVA eval policy waits for the LAVA models.
"""

import numpy as np

from rt1_tpu_torch.serve.engine import PolicyEngine


class RT1EvalPolicy:
    """Closed-loop policy bridging env observations to the model."""

    _SESSION = "eval"

    def __init__(
        self,
        policy,
        action_mean=0.0,
        action_std=1.0,
        action_minimum=-0.03,
        action_maximum=0.03,
    ):
        self._engine = PolicyEngine(
            policy,
            max_sessions=1,
            action_mean=action_mean,
            action_std=action_std,
            action_minimum=action_minimum,
            action_maximum=action_maximum,
        )
        self.reset()

    @property
    def engine(self):
        return self._engine

    # De-normalisation lives in the engine; read-only views.
    @property
    def action_mean(self):
        return self._engine.action_mean

    @property
    def action_std(self):
        return self._engine.action_std

    @property
    def action_minimum(self):
        return self._engine.action_minimum

    @property
    def action_maximum(self):
        return self._engine.action_maximum

    def reset(self):
        """Zero the rolling window (reference `main_rt1.py:158-160`)."""
        self._engine.reset(self._SESSION)

    @property
    def network_state(self):
        """The session's rolling state, unbatched, on the host."""
        return self._engine.session_state(self._SESSION)

    def action(self, observation):
        """One control step. `observation` is the history-stacked obs dict;
        only the last frame is consumed (reference `policy.py:65-66`)."""
        output = self._engine.act(
            self._SESSION,
            {
                "image": np.asarray(observation["rgb_sequence"][-1], np.float32),
                "natural_language_embedding": np.asarray(
                    observation["natural_language_embedding"][-1], np.float32
                ),
            },
        )
        return output["action"]
