"""Plain-python env wrappers for the eval stack (counterpart of
`rt1_tpu/eval/wrappers.py`).

`InstructionEmbeddingWrapper` and `HistoryWrapper` are copies of the JAX
package's. `CentralCropImageWrapper` takes the same central box and
resizes it with the port's native window sampler
(`rt1_tpu_torch/data/native.py::crop_resize_batch`, cv2's `INTER_LINEAR`
convention, within 1 LSB of `cv2.resize`) instead of cv2, which the port
does not depend on. Parity source: reference `language_table/eval/
wrappers.py` (UseTokenWrapper, CentralCropImageWrapper) and tf-agents
`HistoryWrapper(history_length, tile_first_step_obs=True)` as configured
in `eval/main_rt1.py:141-142`.
"""

import collections

import numpy as np

from rt1_tpu_torch.data.native import crop_resize_batch
from rt1_tpu_torch.envs.language_table import LanguageTable


class EnvWrapper:
    """Minimal pass-through wrapper base."""

    def __init__(self, env):
        self._env = env

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self):
        return self._env.reset()

    def step(self, action):
        return self._env.step(action)


class InstructionEmbeddingWrapper(EnvWrapper):
    """Embeds the byte instruction once per episode into the obs, under
    'natural_language_embedding' (reference `UseTokenWrapper`,
    `eval/wrappers.py:26-61`)."""

    def __init__(self, env, embedder, key="natural_language_embedding"):
        super().__init__(env)
        self._embedder = embedder
        self._key = key
        self._current = None

    def reset(self):
        obs = self._env.reset()
        text = LanguageTable.decode_instruction(obs["instruction"])
        self._current = np.asarray(self._embedder(text), np.float32)
        obs[self._key] = self._current
        return obs

    def step(self, action):
        obs, reward, done, info = self._env.step(action)
        obs[self._key] = self._current
        return obs, reward, done, info


class CentralCropImageWrapper(EnvWrapper):
    """Deterministic center-crop + resize, the eval twin of train-time
    random cropping (reference `eval/wrappers.py:64-137`): crop the central
    `crop_factor` box (the *average* random crop) and resize to
    (height, width), float32 in [0, 1], stored as 'rgb_sequence'."""

    def __init__(self, env, target_height, target_width, random_crop_factor):
        super().__init__(env)
        self._h = target_height
        self._w = target_width
        self._factor = random_crop_factor

    def _process(self, obs):
        rgb = obs["rgb"]
        h, w = rgb.shape[:2]
        top, left, ch, cw = 0, 0, h, w
        if self._factor is not None:
            ch, cw = int(h * self._factor), int(w * self._factor)
            top, left = (h - ch) // 2, (w - cw) // 2
        box = np.asarray([[top, left, ch, cw]], np.int32)
        out = crop_resize_batch([rgb], box, self._h, self._w)[0]
        obs["rgb_sequence"] = out.astype(np.float32) / 255.0
        return obs

    def reset(self):
        return self._process(self._env.reset())

    def step(self, action):
        obs, reward, done, info = self._env.step(action)
        return self._process(obs), reward, done, info


class HistoryWrapper(EnvWrapper):
    """Stacks the last `history_length` observations along a leading axis.

    tf-agents `HistoryWrapper(history_length=k, tile_first_step_obs=True)`
    semantics: at reset the first observation is tiled k times; each step
    appends and drops the oldest.
    """

    def __init__(self, env, history_length, keys=None):
        super().__init__(env)
        self._k = history_length
        self._keys = keys
        self._buffer = None

    def _stack(self):
        out = {}
        for key in self._buffer[0]:
            out[key] = np.stack([o[key] for o in self._buffer])
        return out

    def reset(self):
        obs = self._env.reset()
        if self._keys is not None:
            obs = {k: obs[k] for k in self._keys}
        self._buffer = collections.deque([obs] * self._k, maxlen=self._k)
        return self._stack()

    def step(self, action):
        obs, reward, done, info = self._env.step(action)
        if self._keys is not None:
            obs = {k: obs[k] for k in self._keys}
        self._buffer.append(obs)
        return self._stack(), reward, done, info
