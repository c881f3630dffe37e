"""The port's encoder graft against the JAX package's, and the trainer's
graft hook.

* `graft_encoder_into_policy`: one pretrained encoder (random weights at
  0.35/0.35, token width 16, saved by the JAX package and carried across
  by `convert.py`) grafted into a `tiny`-width policy with the 0.35/0.35
  tokenizer in both packages: the port's encoder then holds the file's
  tensors exactly, and the grafted policies' step logits agree within 1e-5
  of max|logit| over a window roll (32x56 frames, float32, dense
  attention). A width or depth coefficient mismatch raises in both and
  leaves the port's policy as it was.
* `VisionPretrainModel`'s train-mode forward (batch statistics, stochastic
  depth off on both sides) within 1e-5 of max|out|, as the eval-mode
  forward in `tests/test_torch_pretrain_vision.py`.
* The trainer's hook (`config.model.pretrained_encoder`): a fresh start
  grafts (the JSON line is logged, the state's encoder is the file's); a
  run that resumes a checkpoint does not graft.
"""

import os

import jax
import numpy as np
import pytest
import torch

from rt1_tpu.train import pretrain_vision as jax_pv
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.train import pretrain_vision as pv
from rt1_tpu_torch.train.train import train_and_evaluate
from test_torch_pretrain_vision import COEFF, EMB, H, TOL, W, _fake_data, _jax_model, \
    _jax_variables
from test_torch_pretrain_vision import test_vision_pretrain_model_matches_jax as _forward
from test_torch_rt1 import init_jax

torch.set_num_threads(2)


def test_vision_pretrain_model_train_mode_matches_jax():
    _forward(train=True)


def _policy_pair(seed):
    """A `tiny`-width policy with the 0.35/0.35 tokenizer in both packages,
    on one set of seeded variables (dense attention)."""
    jcfg = jax_tiny.get_config()
    jcfg.model.image_tokenizer = "efficientnet_small"
    jm = jax_build_model(jcfg.model)
    config = get_config("tiny")
    config.model.image_tokenizer = "efficientnet_small"
    pm = build_policy(config)
    variables = init_jax(jm, jcfg.model.time_sequence_length, seed)
    load_flax_variables(pm, variables["params"], variables["batch_stats"])
    return jm, jax.device_get(variables), pm.eval(), config


def _encoder_file(tmp_path, seed, **coeff):
    """A JAX pretrained encoder (random weights) saved by the JAX package,
    and the same encoder as the port's state_dict."""
    jm = _jax_model(**coeff)
    variables = _jax_variables(jm, seed)
    path = str(tmp_path / f"enc_{seed}.msgpack")
    jax_pv.save_encoder(variables, {"val_rmse": 0.1, "history": []}, path)
    enc = jax_pv.load_encoder(path)
    return enc, state_dict_from_flax(enc["params"], enc["batch_stats"])


def test_graft_matches_jax(tmp_path):
    jm, variables, pm, _ = _policy_pair(seed=5)
    enc, port_enc = _encoder_file(tmp_path, seed=6)
    grafted = jax_pv.graft_encoder_into_policy(variables, enc)
    assert pv.graft_encoder_into_policy(pm, port_enc) is pm
    own = pm.image_tokenizer.encoder.state_dict()
    for key, value in port_enc.items():
        assert torch.equal(own[key], value), key
    jax_step = jax.jit(lambda v, o, s: jm.apply(v, o, s, method=jm.infer_step))
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((2, 512)).astype(np.float32)
    jstate, pstate = jm.initial_state(2), pm.initial_state(2)
    for step in range(jm.time_sequence_length + 2):
        frame = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
        jout, jstate = jax_step(grafted, {"image": frame, "natural_language_embedding": emb},
                                jstate)
        with torch.no_grad():
            pout, pstate = pm.infer_step({"image": torch.from_numpy(frame),
                                          "natural_language_embedding": torch.from_numpy(emb)},
                                         pstate)
        ref = np.asarray(jout["action_logits"])
        np.testing.assert_allclose(pout["action_logits"].numpy(), ref, rtol=0,
                                   atol=TOL * float(np.abs(ref).max()), err_msg=f"step {step}")


def test_graft_coefficient_mismatch_raises_in_both(tmp_path):
    jm, variables, pm, _ = _policy_pair(seed=7)
    enc, port_enc = _encoder_file(tmp_path, seed=8, width_coefficient=0.7,
                                  depth_coefficient=0.35)
    with pytest.raises(ValueError, match="mismatch"):
        jax_pv.graft_encoder_into_policy(variables, enc)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    with pytest.raises(ValueError, match="mismatch"):
        pv.graft_encoder_into_policy(pm, port_enc)
    assert all(torch.equal(before[k], v) for k, v in pm.state_dict().items())
    # A deeper encoder: the key sets differ.
    _, deeper = _encoder_file(tmp_path, seed=9, width_coefficient=0.35, depth_coefficient=0.7)
    with pytest.raises(ValueError, match="tree mismatch"):
        pv.graft_encoder_into_policy(pm, deeper)


def test_trainer_grafts_on_a_fresh_start_only(tmp_path):
    _, _, pm, config = _policy_pair(seed=10)
    images, targets = _fake_data()
    model, metrics = pv.pretrain_encoder(images, targets, num_steps=1, batch_size=4,
                                         token_embedding_size=EMB, device="cpu",
                                         log=lambda *_: None, **COEFF)
    path = str(tmp_path / "enc.pt")
    pv.save_encoder(model, metrics, path)
    config.model.pretrained_encoder = path
    config.data.height, config.data.width = H, W
    config.per_host_batch_size = 2
    config.eval_every_steps = 0
    workdir = str(tmp_path / "run")
    logs = []
    config.num_steps = 0  # nothing trains: the state is the graft's
    state = train_and_evaluate(config, workdir, device="cpu", log=logs.append)
    assert {"status": "grafted_pretrained_encoder", "path": path} in logs
    grafted = state.policy.image_tokenizer.encoder.state_dict()
    for key, value in model.encoder.state_dict().items():
        assert torch.equal(grafted[key], value), key
    config.num_steps = 1
    logs.clear()
    train_and_evaluate(config, workdir, device="cpu", log=logs.append)
    assert {"status": "grafted_pretrained_encoder", "path": path} in logs
    config.num_steps = 2
    logs.clear()
    state = train_and_evaluate(config, workdir, device="cpu", log=logs.append)
    assert logs[0]["restored_step"] == 1
    assert not any(r.get("status") == "grafted_pretrained_encoder" for r in logs)
    assert os.path.isdir(os.path.join(workdir, "checkpoints", "2"))
