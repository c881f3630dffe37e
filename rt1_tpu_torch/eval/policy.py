"""The closed-loop RT-1 eval policy (counterpart of `rt1_tpu/eval/policy.py`).

`RT1EvalPolicy` is a one-slot wrapper over the port's serving engine
(`serve/engine.py::PolicyEngine`), as the JAX package's is over its own:
it feeds the LAST frame of the history-stacked observation, keeps the
rolling network state on the device across steps, and de-normalises and
clips the decoded action in the engine (parity source: reference
`language_table/train/policy.py:32-112`, `BCJaxPyPolicyRT1`). One control
step is one `RT1Policy.infer_step`; with fused attention on the card it
launches the attention kernel once per decoder layer.

`LavaEvalPolicy` is the LAVA family's (Stack B's `BCJaxPyPolicy`): one
`SequenceLAVMSE` forward over the last `sequence_length` frames of the
history, the MSE head's action de-normalised and clipped; stateless
between steps (the history wrapper holds the context).
"""

import numpy as np
import torch

from rt1_tpu_torch.data.episodes import decode_instruction_text
from rt1_tpu_torch.serve.engine import PolicyEngine

EPS = np.finfo(np.float32).eps
# The observation keys the history wrapper stacks for LAVA's "clip"
# encoder: RT-1's and the raw instruction bytes, tokenized per episode.
LAVA_CLIP_HISTORY_KEYS = ("rgb_sequence", "natural_language_embedding", "instruction",
                          "effector_translation", "effector_target_translation")


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


class LavaEvalPolicy:
    """Closed-loop policy of the LAVA family (reference `train/policy.py:
    114-173`, `eval/main.py:54-145`): the history-stacked observation's
    last `sequence_length` frames through one forward of `model` (a
    `SequenceLAVMSE` in eval mode on its device), the action de-normalised
    and clipped. With a `clip_tokenizer` the episode's instruction
    (`observation["instruction"][-1]`, zero-padded UTF-8 bytes) is
    tokenized once per instruction."""

    def __init__(self, model, sequence_length, clip_tokenizer=None, action_mean=0.0,
                 action_std=1.0, action_minimum=-0.03, action_maximum=0.03):
        self._model = model
        self._sequence_length = sequence_length
        self._clip_tokenizer = clip_tokenizer
        self.action_mean = action_mean
        self.action_std = action_std
        self.action_minimum = action_minimum
        self.action_maximum = action_maximum
        self._token_cache_key = None
        self._token_cache = None

    def reset(self):
        pass  # stateless: history comes from the wrapper

    def _tokens_for(self, instruction_bytes):
        """(1, t, context) int32 tokens of the instruction, cached per text:
        BPE on the 10 Hz control path would be repeated host work."""
        key = np.asarray(instruction_bytes).tobytes()
        if key != self._token_cache_key:
            raw = np.asarray(instruction_bytes)
            text = decode_instruction_text(raw[raw != 0])
            tokens = self._clip_tokenizer.tokenize_text(text)[0]
            self._token_cache = np.tile(tokens[None, None, :], (1, self._sequence_length, 1))
            self._token_cache_key = key
        return self._token_cache

    def action(self, observation):
        t = self._sequence_length
        device = next(self._model.parameters()).device
        obs = {
            "rgb": np.asarray(observation["rgb_sequence"][-t:][None], np.float32),
            "natural_language_embedding": np.asarray(
                observation["natural_language_embedding"][-t:][None], np.float32),
        }
        if self._clip_tokenizer is not None:
            obs["instruction_tokenized_clip"] = self._tokens_for(observation["instruction"][-1])
        with torch.no_grad():
            action = self._model({k: torch.from_numpy(v).to(device) for k, v in obs.items()})
        action = action[0].float().cpu().numpy()
        action = action * max(self.action_std, EPS) + self.action_mean
        return np.clip(action, self.action_minimum, self.action_maximum)
