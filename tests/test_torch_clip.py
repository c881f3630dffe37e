"""CLIP BPE, the CLIP text tower and the engine's embedding cache of the
port against the JAX package.

* `ClipBPETokenizer`: ids identical to JAX's on every 40th Language-Table
  instruction of BLOCK_4 (~316) and on case, whitespace, punctuation and
  contraction variants, for the byte-level `default_tokenizer` and for a
  tokenizer with merges, with the `regex` split and with the stdlib
  fallback forced on both sides (the card's machine has no `regex`); the
  fallback's ids equal the `regex` ones on these ASCII texts.
* `data.clip_tokens`: the windowed loader's and the packed feeder's
  `instruction_tokenized_clip` equal JAX's windowed loader's.
* `CLIPTextEncoder` on JAX's weights (carried by `convert.py`) within
  1e-5; EOT pooling: the features follow the argmax position and ignore
  the padded tail.
* `convert_clip_text_state_dict` on a synthetic OpenAI-layout state dict:
  the port's state_dict equals JAX's converted tree, and the two towers
  agree within 1e-5.
* The serving engine's embedding cache keys on BPE ids, as JAX's does:
  case and whitespace variants hit one entry (one embedder call), keys
  equal JAX's `_embed_key`, the raw-bytes fallback past 77 tokens.
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt1_tpu.text.clip_bpe as jax_bpe
from rt1_tpu.data.pipeline import WindowedEpisodeDataset as JaxWindowedEpisodeDataset
from rt1_tpu.models.lava.clip_text import CLIPTextEncoder as JaxCLIPTextEncoder
from rt1_tpu.models.lava.clip_text import convert_clip_text_state_dict as jax_convert
from rt1_tpu.serve.engine import PolicyEngine as JaxPolicyEngine
from rt1_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.data import episodes as ep_lib
from rt1_tpu_torch.data import pack as pack_lib
from rt1_tpu_torch.data.feeder import SampleAheadFeeder
from rt1_tpu_torch.data.pipeline import WindowedEpisodeDataset
from rt1_tpu_torch.envs import blocks
from rt1_tpu_torch.envs.rewards import generate_all_instructions
from rt1_tpu_torch.models.lava.clip_text import CLIPTextEncoder, convert_clip_text_state_dict
from rt1_tpu_torch.serve.engine import PolicyEngine
from rt1_tpu_torch.text import clip_bpe
from test_clip_text import CTX, EMBED, HEADS, LAYERS, VOCAB, WIDTH, clip_frame, \
    random_torch_state_dict
from test_torch_train_policy import tiny_pair

torch.set_num_threads(2)

MERGES = [("t", "h"), ("th", "e</w>"), ("h", "e</w>"), ("b", "l"), ("bl", "o"),
          ("c", "k</w>"), ("r", "e"), ("re", "d</w>"), ("p", "u"), ("pu", "s"), ("pus", "h</w>")]
VARIANTS = [
    "push the red star to the blue cube",
    "Push the RED star to the Blue Cube",
    "  push   the red star\tto the blue cube  ",
    "push the red star to the blue cube.",
    "put the green circle next to the yellow heart",
    "it's the red moon, isn't it? we'll move it; they've done it & I'd go",
    "move the block 2 inches left!!",
    "slide the blue cube to the top left corner",
]


def _instructions():
    every = sorted(generate_all_instructions(blocks.BlockMode.BLOCK_4))
    return every[::40] + VARIANTS


def _fallback(raw):
    return re.compile(raw.replace(r"\p{L}", "a-zA-Z").replace(r"\p{N}", "0-9"), re.IGNORECASE)


@pytest.mark.parametrize("merges", [[], MERGES], ids=["byte_level", "merges"])
@pytest.mark.parametrize("split", ["regex", "stdlib"])
def test_bpe_ids_equal_jax(monkeypatch, merges, split):
    if split == "stdlib":
        monkeypatch.setattr(jax_bpe, "_PATTERN", _fallback(jax_bpe._RAW_PATTERN))
        monkeypatch.setattr(clip_bpe, "_PATTERN", clip_bpe.split_pattern(use_regex=False))
    texts = _instructions()
    ours = clip_bpe.ClipBPETokenizer(merges).tokenize_text(texts)
    theirs = jax_bpe.ClipBPETokenizer(merges).tokenize_text(texts)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == np.int32 and ours.shape == (len(texts), 77)
    regex_ids = clip_bpe.ClipBPETokenizer(merges)
    monkeypatch.setattr(clip_bpe, "_PATTERN", clip_bpe.split_pattern(use_regex=True))
    np.testing.assert_array_equal(regex_ids.tokenize_text(texts), ours)
    # Case and whitespace fold; punctuation does not.
    v = ours[len(texts) - len(VARIANTS):]
    assert (v[0] == v[1]).all() and (v[0] == v[2]).all()
    assert not (v[0] == v[3]).all()


def test_default_tokenizer_vocab_and_framing():
    tok = clip_bpe.default_tokenizer()
    assert tok.vocab_size == 514 == jax_bpe.default_tokenizer().vocab_size
    ids = tok.tokenize_text("push")[0]
    assert ids[0] == tok.sot_token == 512 and ids[5] == tok.eot_token == 513
    assert tok.decode(ids[1:5]) == "push"
    with pytest.raises(ValueError, match="too long"):
        tok.tokenize_text("x" * 80)


def _write_corpus(root, n=3, steps=6, h=24, w=32):
    paths = []
    for i in range(n):
        ep = ep_lib.generate_synthetic_episode(np.random.default_rng(i), steps, h, w)
        ep["instruction_text"] = ep_lib.encode_instruction_text(VARIANTS[i])
        path = str(root / f"episode_{i:03d}.npz")
        ep_lib.save_episode(path, ep)
        paths.append(path)
    return paths


def test_clip_tokens_of_the_loaders_equal_jax(tmp_path):
    paths = _write_corpus(tmp_path)
    kw = dict(window=3, crop_factor=None, height=16, width=24)
    ours = WindowedEpisodeDataset(paths, clip_tokenizer=clip_bpe.default_tokenizer(), **kw)
    theirs = JaxWindowedEpisodeDataset(paths, clip_tokenizer=jax_bpe.default_tokenizer(), **kw)
    assert len(ours) == len(theirs)
    for idx in range(0, len(ours), 4):
        got = ours.get_window(idx, np.random.default_rng(0))["observations"]
        want = theirs.get_window(idx, np.random.default_rng(0))["observations"]
        np.testing.assert_array_equal(got["instruction_tokenized_clip"],
                                      want["instruction_tokenized_clip"])
        assert got["instruction_tokenized_clip"].dtype == np.int32
        assert got["instruction_tokenized_clip"].shape == (3, 77)
    pack_dir = str(tmp_path / "pack")
    pack_lib.pack_episodes(paths, pack_dir, 16, 24, None)
    cache = pack_lib.PackedEpisodeCache(pack_dir, window=3,
                                        clip_tokenizer=clip_bpe.default_tokenizer())
    feeder = SampleAheadFeeder(cache, 4, seed=0, num_epochs=1)
    try:
        batch = next(iter(feeder))
    finally:
        feeder.close()
    tokens = batch["observations"]["instruction_tokenized_clip"]
    assert tokens.shape == (4, 3, 77)
    known = {tuple(ours._episode_clip_tokens(i)) for i in range(len(paths))}
    assert {tuple(row[0]) for row in tokens} <= known
    assert (tokens == tokens[:, :1]).all()


def _towers(seed=0):
    tokens = jnp.asarray(clip_frame(np.random.default_rng(seed), 3, 4))
    jt = JaxCLIPTextEncoder(vocab_size=VOCAB, context_length=CTX, width=WIDTH,
                            num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED)
    variables = jt.init(jax.random.PRNGKey(seed), tokens)
    pt = CLIPTextEncoder(VOCAB, CTX, WIDTH, LAYERS, HEADS, EMBED)
    load_flax_variables(pt, variables["params"])
    return jt, variables, pt


def test_clip_text_encoder_matches_jax():
    jt, variables, pt = _towers()
    for seed, body in ((1, 3), (2, 7), (3, CTX - 2)):
        tokens = clip_frame(np.random.default_rng(seed), 4, body)
        want = np.asarray(jt.apply(variables, jnp.asarray(tokens)))
        with torch.no_grad():
            got = pt(torch.from_numpy(tokens)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_eot_pooling():
    jt, variables, pt = _towers(4)
    tokens = clip_frame(np.random.default_rng(5), 2, 3)  # EOT at position 4
    with torch.no_grad():
        base = pt(torch.from_numpy(tokens))
        tail = tokens.copy()
        tail[:, 6:] = 7  # change only the padded tail past the EOT
        np.testing.assert_array_equal(pt(torch.from_numpy(tail)).numpy(), base.numpy())
        moved = tokens.copy()
        moved[:, 4], moved[:, 5] = 3, VOCAB - 1  # EOT one step later
        assert not torch.allclose(pt(torch.from_numpy(moved)), base)
    np.testing.assert_allclose(
        pt(torch.from_numpy(moved)).detach().numpy(),
        np.asarray(jt.apply(variables, jnp.asarray(moved))), atol=1e-5, rtol=0)


def test_openai_layout_converter_matches_jax():
    sd = random_torch_state_dict(np.random.default_rng(6))
    want = state_dict_from_flax(jax_convert(sd, num_heads=HEADS))
    got = convert_clip_text_state_dict(sd)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    assert set(convert_clip_text_state_dict(sd, prefix="encoder.text_encoder.")) == {
        "encoder.text_encoder." + k for k in got}
    pt = CLIPTextEncoder(VOCAB, CTX, WIDTH, LAYERS, HEADS, EMBED)
    pt.load_state_dict(got, strict=True)
    jt = JaxCLIPTextEncoder(vocab_size=VOCAB, context_length=CTX, width=WIDTH,
                            num_layers=LAYERS, num_heads=HEADS, embed_dim=EMBED)
    tokens = clip_frame(np.random.default_rng(7), 3, 5)
    want_out = np.asarray(jt.apply({"params": jax_convert(sd, num_heads=HEADS)},
                                   jnp.asarray(tokens)))
    with torch.no_grad():
        np.testing.assert_allclose(pt(torch.from_numpy(tokens)).numpy(), want_out, atol=1e-5,
                                   rtol=0)
    with pytest.raises(KeyError, match="resblocks"):
        convert_clip_text_state_dict({k: v for k, v in sd.items() if "resblocks" not in k})


def test_engine_cache_hits_case_and_whitespace_variants():
    _, pm, _ = tiny_pair(81)
    calls = []

    def embedder(text):
        calls.append(text)
        return np.full((512,), len(calls), np.float32)

    engine = PolicyEngine(pm.eval(), max_sessions=2, embedder=embedder)
    frame = np.zeros((32, 56, 3), np.float32)
    for i, text in enumerate(VARIANTS[:3]):
        engine.act(f"s{i}", {"image": frame, "instruction": text})
    assert engine.embed_calls == 1 and calls == [VARIANTS[0]]
    engine.act("s3", {"image": frame, "instruction": VARIANTS[3]})  # punctuation differs
    assert engine.embed_calls == 2
    jax_self = types.SimpleNamespace(_tokenizer=None)
    for text in VARIANTS + ["x" * 100]:
        assert engine._embed_key(text) == JaxPolicyEngine._embed_key(jax_self, text)
    assert engine._embed_key("x" * 100).startswith(b"raw\x00")
    # The exporter's peek and the migration seed use the same key.
    np.testing.assert_array_equal(engine.cached_embedding(VARIANTS[1]), np.full((512,), 1))
    engine.seed_embedding("PUT the green circle next to the yellow heart", np.zeros(512))
    assert engine.cached_embedding(VARIANTS[4]) is not None
