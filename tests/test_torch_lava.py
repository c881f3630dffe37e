"""The LAVA model family of the port against the JAX package.

* `SequenceLAVMSE` at `lava_tiny` widths (d_model 16, 64x64, window 3)
  with the conv_maxpool, resnet and clip encoders, and `PixelLangMSE`, on
  JAX's weights carried by `convert.py` (randomised, BatchNorm statistics
  included): actions within 1e-4 abs in eval mode.
* `positional_encoding_2d` and the 1-D table equal JAX's; the resnet
  encoder's `F.interpolate` resize within 1e-5 of `jax.image.resize(...,
  "bilinear", antialias=False)` at 256x456 and 64x64 -> 224.
* `bc_mse_loss` (plain and normalised) within 1e-7 relative;
  `make_bc_optimizer` with the CLIP tower frozen against optax's
  multi_transform over two steps: frozen parameters bit-unchanged, the
  rest within 1e-6; `remap_pretrained_params` equal to JAX's, and its
  errors.
* The LAVA train loss and gradients through the port's trainer
  (`train_step_fns_from_config`) against `make_bc_step_loss_fn` (dropout
  disabled on both sides, since the two draw different masks): loss rtol
  1e-5, gradients atol 1e-5 of the largest.
* `LavaEvalPolicy.action` against JAX's on the same history observation,
  with and without the CLIP tokens (1e-6).
* The train CLI (2 steps, a checkpoint), the eval CLI and one eval-matrix
  cell on a LAVA checkpoint, on the CPU.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rt1_tpu.eval.policy import LavaEvalPolicy as JaxLavaEvalPolicy
from rt1_tpu.models.lava import PixelLangMSE as JaxPixelLangMSE
from rt1_tpu.models.lava import blocks as jax_blocks
from rt1_tpu.models.lava.lava import normalize_image_resnet as jax_normalize
from rt1_tpu.text.clip_bpe import default_tokenizer as jax_default_tokenizer
from rt1_tpu.train.configs import lava_tiny as jax_lava_tiny
from rt1_tpu.train.train import build_family
from rt1_tpu.trainer import bc as jax_bc
from rt1_tpu_torch.configs import apply_override, get_config
from rt1_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.eval import main as eval_main
from rt1_tpu_torch.eval import matrix as port_matrix
from rt1_tpu_torch.eval.policy import LavaEvalPolicy
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.models.lava import PixelLangMSE, blocks
from rt1_tpu_torch.models.lava import lava as lava_lib
from rt1_tpu_torch.models.lava.clip_text import FROZEN_PREFIX
from rt1_tpu_torch.models.lava.lava import normalize_image_resnet
from rt1_tpu_torch.text.clip_bpe import default_tokenizer
from rt1_tpu_torch.train.train import train_and_evaluate
from rt1_tpu_torch.trainer import bc
from rt1_tpu_torch.trainer.state import create_train_state
from rt1_tpu_torch.trainer.train import train_step_fns_from_config
from test_torch_modules import randomized

torch.set_num_threads(2)

B, T, H, W = 2, 3, 64, 64


def _configs(image_encoder="conv_maxpool", lang_encoder="embedding_in_obs"):
    jcfg = jax_lava_tiny.get_config()
    jcfg.model.lava.image_encoder = image_encoder
    jcfg.model.lava.lang_encoder = lang_encoder
    cfg = get_config("lava_tiny")
    apply_override(cfg, f"model.lava.image_encoder={image_encoder}")
    apply_override(cfg, f"model.lava.lang_encoder={lang_encoder}")
    if lang_encoder == "clip":
        jcfg.data.clip_tokens = True
        apply_override(cfg, "data.clip_tokens=true")
    return jcfg, cfg


def _obs(seed, clip=False):
    rng = np.random.default_rng(seed)
    obs = {"image": rng.uniform(0, 1, (B, T, H, W, 3)).astype(np.float32),
           "natural_language_embedding": rng.standard_normal((B, T, 512)).astype(np.float32)}
    if clip:
        texts = ["push the red star to the blue cube", "Move the green circle left"]
        tokens = jax_default_tokenizer().tokenize_text(texts)
        obs["instruction_tokenized_clip"] = np.repeat(tokens[:, None], T, axis=1)
    return obs


def _pair(seed, image_encoder="conv_maxpool", lang_encoder="embedding_in_obs"):
    jcfg, cfg = _configs(image_encoder, lang_encoder)
    jm, init_fn, _ = build_family(jcfg.model)
    example = _obs(0, clip=lang_encoder == "clip")
    shapes = jax.eval_shape(lambda k: init_fn(jm, k, example, None), jax.random.PRNGKey(0))
    variables = randomized(shapes, seed)
    pm = build_policy(cfg)
    load_flax_variables(pm, variables["params"], variables.get("batch_stats"))
    return jm, pm.eval(), variables, cfg


def _port_obs(obs):
    out = {k: torch.from_numpy(v) for k, v in obs.items()}
    out["rgb"] = out.pop("image")
    return out


@pytest.mark.parametrize("image_encoder,lang_encoder", [
    ("conv_maxpool", "embedding_in_obs"), ("resnet", "embedding_in_obs"),
    ("conv_maxpool", "clip")])
def test_sequence_lav_mse_matches_jax(image_encoder, lang_encoder):
    jm, pm, variables, _ = _pair(11, image_encoder, lang_encoder)
    obs = _obs(12, clip=lang_encoder == "clip")
    want = np.asarray(jax.jit(lambda v, o: jm.apply(v, jax_bc.adapt_obs_for_lava(o)))(
        variables, obs))
    with torch.no_grad():
        got = pm(_port_obs(obs)).numpy()
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pixel_lang_mse_matches_jax():
    rng = np.random.default_rng(13)
    obs = {"rgb": rng.uniform(0, 1, (B, T, 32, 32, 3)).astype(np.float32),
           "natural_language_embedding": rng.standard_normal((B, T, 32)).astype(np.float32)}
    jm = JaxPixelLangMSE(action_size=2, dense_resnet_width=32, dense_resnet_num_blocks=2)
    variables = randomized(jax.eval_shape(lambda k: jm.init({"params": k}, obs),
                                          jax.random.PRNGKey(0)), 14)
    pm = PixelLangMSE(2, 32, 2, num_frames=T, lang_dim=32)
    load_flax_variables(pm, variables["params"])
    with torch.no_grad():
        got = pm.eval()({k: torch.from_numpy(v) for k, v in obs.items()}).numpy()
    want = np.asarray(jax.jit(jm.apply)(variables, obs))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_position_tables_equal_jax():
    for d, h, w in ((16, 4, 4), (128, 8, 14), (32, 5, 7)):
        np.testing.assert_array_equal(blocks.positional_encoding_2d(d, h, w),
                                      np.asarray(jax_blocks.positional_encoding_2d(d, h, w)))
    np.testing.assert_array_equal(blocks.sinusoidal_position_encoding(6, 128),
                                  np.asarray(jax_blocks.sinusoidal_position_encoding(6, 128)))
    with pytest.raises(ValueError, match="% 4"):
        blocks.positional_encoding_2d(6, 2, 2)


@pytest.mark.parametrize("hw", [(256, 456), (64, 64)])
def test_resnet_resize_matches_jax_image_resize(hw):
    images = np.random.default_rng(15).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.transpose(np.asarray(jax_normalize(jnp.asarray(images))), (0, 3, 1, 2))
    got = normalize_image_resnet(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 3, 224, 224)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bc_mse_loss_matches_jax():
    rng = np.random.default_rng(16)
    pred, target = (rng.standard_normal((4, 2)).astype(np.float32) for _ in range(2))
    mean, std = np.float32([0.1, -0.2]), np.float32([0.5, 2.0])
    for args in ((), (mean, std)):
        want = float(jax_bc.bc_mse_loss(pred, target, *args))
        got = bc.bc_mse_loss(torch.from_numpy(pred), torch.from_numpy(target),
                             *map(torch.from_numpy, args)).item()
        assert got == pytest.approx(want, rel=1e-7)


def test_bc_optimizer_freezes_the_clip_tower_like_optax():
    _, pm, variables, _ = _pair(17, lang_encoder="clip")
    params = variables["params"]
    tx = jax_bc.make_bc_optimizer(1e-3, frozen_prefixes=("encoder/text_encoder",))
    opt_state = tx.init(params)
    step = jax.jit(lambda g, o, p: (lambda u, o2: (optax.apply_updates(p, u), o2))(
        *tx.update(g, o, p)))
    state = create_train_state(pm, bc.make_bc_optimizer(1e-3, frozen_prefixes=(FROZEN_PREFIX,)))
    optimizer = bc.make_bc_optimizer(1e-3, frozen_prefixes=(FROZEN_PREFIX,))
    optimizer.bind(state.names, state.layout, "cpu")
    before = state.flat.clone()
    rng = np.random.default_rng(18)
    for _ in range(2):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 1e-2,
                             params)
        params, opt_state = step(grads, opt_state, params)
        flat_grad = state.layout.flatten([state_dict_from_flax(grads)[n] for n in state.names])
        new, state.opt_state = optimizer.update(flat_grad, state.opt_state, state.flat)
        state.flat.copy_(new)
    want = state_dict_from_flax(jax.device_get(params))
    views = dict(zip(state.names, state.layout.views(state.flat)))
    originals = dict(zip(state.names, state.layout.views(before)))
    frozen = [n for n in state.names if bc.is_frozen(n, (FROZEN_PREFIX,))]
    assert frozen and len(frozen) < len(state.names)
    for name, value in views.items():
        if name in frozen:
            assert torch.equal(value, originals[name]), name
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert not bc.is_frozen("encoder.text_encoder_extra.w", (FROZEN_PREFIX,))
    assert bc.is_frozen("encoder.text_encoder.ln_final.weight", ("encoder/text_encoder",))


def test_remap_pretrained_params_matches_jax():
    jparams = {"encoder": {"text": {"w": np.zeros((2, 2), np.float32)}},
               "head": {"w": np.zeros((2,), np.float32)}}
    jpre = {"backbone": {"w": np.ones((2, 2), np.float32)}}
    want = jax_bc.remap_pretrained_params(jparams, jpre, {"backbone": "encoder/text"})
    params = {"encoder.text.w": torch.zeros(2, 2), "head.w": torch.zeros(2)}
    pre = {"backbone.w": torch.ones(2, 2)}
    got = bc.remap_pretrained_params(params, pre, {"backbone": "encoder/text"})
    np.testing.assert_array_equal(got["encoder.text.w"], want["encoder"]["text"]["w"])
    np.testing.assert_array_equal(got["head.w"], want["head"]["w"])
    with pytest.raises(KeyError, match="No pretrained"):
        bc.remap_pretrained_params(params, pre, {"missing": "head"})
    with pytest.raises(KeyError, match="not present"):
        bc.remap_pretrained_params(params, pre, {"backbone": "nowhere"})
    with pytest.raises(ValueError, match="Shape mismatch"):
        bc.remap_pretrained_params(params, pre, {"backbone": "head"})


def _no_dropout(monkeypatch):
    identity = lambda x, *args, **kwargs: x  # noqa: E731
    monkeypatch.setattr(blocks, "dropout", identity)
    monkeypatch.setattr(lava_lib, "dropout", identity)
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


@pytest.mark.parametrize("lang_encoder", ["embedding_in_obs", "clip"])
def test_lava_train_loss_matches_bc_step_loss_fn(monkeypatch, lang_encoder):
    _no_dropout(monkeypatch)
    jm, pm, variables, cfg = _pair(19, lang_encoder=lang_encoder)
    obs = _obs(20, clip=lang_encoder == "clip")
    obs["image"] = (obs["image"] * 255).astype(np.uint8)  # the wire dtype
    actions = {"action": np.random.default_rng(21).uniform(-0.1, 0.1, (B, T, 2))
               .astype(np.float32),
               "terminate_episode": np.zeros((B, T), np.int32)}
    loss_fn = jax_bc.make_bc_step_loss_fn(jm)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, {}, (obs, actions), jax.random.PRNGKey(0), True), has_aux=True))(
            variables["params"])
    fns = train_step_fns_from_config(cfg)
    assert fns.compute_dtype == torch.float32 and fns.loss_fn is not None
    state = create_train_state(pm.train(), fns.optimizer)
    batch = ({k: torch.from_numpy(v) for k, v in obs.items()},
             {k: torch.from_numpy(v) for k, v in actions.items()})
    loss, grad, _ = fns.value_and_grad(state, batch, 0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = state_dict_from_flax(jax.device_get(jgrads))
    scale = max(float(g.abs().max()) for g in ref.values())
    for name, g in fns.grads_by_name(state, grad).items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-5 * scale, rtol=0,
                                   err_msg=name)
    jeval, _ = jax.jit(lambda p: loss_fn(p, {}, (obs, actions), None, False))(
        variables["params"])
    np.testing.assert_allclose(fns.eval_step(state, batch)["loss"].item(), float(jeval),
                               rtol=1e-5)


@pytest.mark.parametrize("lang_encoder", ["embedding_in_obs", "clip"])
def test_lava_eval_policy_matches_jax(lang_encoder):
    jm, pm, variables, _ = _pair(22, lang_encoder=lang_encoder)
    clip = lang_encoder == "clip"
    rng = np.random.default_rng(23)
    text = np.zeros((T + 1, 64), np.uint8)
    text[:, :12] = np.frombuffer(b"push the red", np.uint8)
    observation = {
        "rgb_sequence": rng.uniform(0, 1, (T + 1, H, W, 3)).astype(np.float32),
        "natural_language_embedding": rng.standard_normal((T + 1, 512)).astype(np.float32),
        "instruction": text,
    }
    kw = dict(sequence_length=T, action_mean=0.01, action_std=0.5)
    theirs = JaxLavaEvalPolicy(jm, variables,
                               clip_tokenizer=jax_default_tokenizer() if clip else None, **kw)
    ours = LavaEvalPolicy(pm, clip_tokenizer=default_tokenizer() if clip else None, **kw)
    for _ in range(2):  # the second call reads the token cache
        np.testing.assert_allclose(ours.action(observation), theirs.action(observation),
                                   atol=1e-6, rtol=0)


def test_lava_train_eval_cli_and_matrix_cell(tmp_path, capsys):
    cfg = get_config("lava_tiny")
    for assignment in ("num_steps=2", "eval_every_steps=2", "per_host_batch_size=2"):
        apply_override(cfg, assignment)
    records = []
    train_and_evaluate(cfg, str(tmp_path), device="cpu", log=records.append)
    assert records[-1]["checkpoint_step"] == 2
    assert np.isfinite([r["loss"] for r in records if "loss" in r]).all()
    assert "eval_token_accuracy" not in [r for r in records if "eval_loss" in r][0]
    capsys.readouterr()
    assert eval_main.main(["--config", "lava_tiny", "--workdir", str(tmp_path), "--device", "cpu",
                           "--episodes", "1", "--max_steps", "3", "--block_mode", "BLOCK_4",
                           "--set", "per_host_batch_size=2"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["checkpoint_step"] == 2 and result["episodes_per_reward"] == 1
    policy, restored, history_keys = port_matrix.policy_for_checkpoint(cfg, str(tmp_path), 2,
                                                                       device="cpu")
    assert isinstance(policy, LavaEvalPolicy) and restored == 2 and history_keys is None
    state = port_matrix.run_matrix([("ckpt2", policy)], ["block2block"], episodes_per_cell=1,
                                   max_episode_steps=3, block_mode="BLOCK_4",
                                   env_kwargs=dict(target_height=H, target_width=W,
                                                   sequence_length=T))
    cell = state.matrix()["block2block"]["ckpt2"]
    assert cell["episodes"] == 1
