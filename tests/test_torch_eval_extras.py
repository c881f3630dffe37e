"""What the eval and the learning proof had left out, against the JAX
package, on the CPU.

* Table embedder: `python -m rt1_tpu_torch.eval.embedding` and the JAX
  CLI write the same instructions and bitwise-equal embeddings; each
  package's `TableInstructionEmbedder` reads the other's file; N_CHOOSE_K
  is refused by both.
* Planner plot: `draw_planner` and `draw_oracle_plan` byte for byte
  JAX's on the cases of `tests/test_oracles.py` (and at the default
  360x640, and over a resized frame).
* Overlay: `add_debug_info_to_image` gives JAX's canvas shape and strip
  height, and the frame region byte for byte (the port's resize is PIL's
  bilinear filter); the strip is white outside the text lines in both.
  Text pixels are not compared: the fonts differ (the port's 5x7 bitmap,
  PIL's default font in JAX).
* Videos: an evaluated episode's GIF decodes with PIL to steps + 1
  frames, under JAX's folder and file stem, and `count_gif_frames` counts
  its frames and those of JAX's GIFs as PIL does; `write_gif` of rendered
  overlay frames decodes within its palette tolerance (at least 99 % of
  pixels exact, a mean error under 0.1 levels, none off by more than 64).
* Closed-loop diagnostics: the report of `scripts/policy_diagnostics.py`'s
  loop (compiled from its source, on JAX's `tiny` policy) and of
  `closed_loop_diagnostics` (the port's, on the same weights) have the
  same keys and values within 1e-6.
* Encoders: a flax msgpack encoder written by JAX's `save_encoder` loads
  with every leaf bit for bit equal to the JAX package's own reading
  (plain, with bfloat16 leaves, and with flax's chunked arrays), and the
  policy grafted from it steps within 1e-5 of max|logit| of JAX's graft.
* Perception probe: JAX's arms; the port's report has the JAX script's
  keys; its saved encoder grafts.
"""

import ast
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rt1_tpu.envs import blocks as jax_blocks
from rt1_tpu.envs import rendering as jax_rendering
from rt1_tpu.envs.oracles import plot as jax_plot
from rt1_tpu.envs.oracles.rrt_star import RRTStarPlanner as JaxPlanner
from rt1_tpu.eval import embedding as jax_embedding
from rt1_tpu.eval import evaluate as jax_evaluate
from rt1_tpu.eval.policy import RT1EvalPolicy as JaxRT1EvalPolicy
from rt1_tpu.train import pretrain_vision as jax_pv
from rt1_tpu_torch.convert import state_dict_from_flax
from rt1_tpu_torch.envs import blocks, rendering
from rt1_tpu_torch.envs.oracles import plot
from rt1_tpu_torch.envs.oracles.rrt_star import RRTStarPlanner
from rt1_tpu_torch.eval import diagnostics, embedding, evaluate, wrappers
from rt1_tpu_torch.eval.policy import RT1EvalPolicy
from rt1_tpu_torch.eval.video import count_gif_frames, write_gif
from rt1_tpu_torch.train import perception_probe
from rt1_tpu_torch.train import pretrain_vision as pv
from rt1_tpu_torch.utils import flax_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTION_TOL = 1e-6
GIF_EXACT_SHARE, GIF_MEAN_ERR, GIF_MAX_ERR = 0.99, 0.1, 64

torch.set_num_threads(2)


# ------------------------------------------------------------ table embedder


def test_table_cli_matches_jax_and_each_reads_the_other(tmp_path, monkeypatch):
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    args = ["--block_mode", "BLOCK_8", "--embedder", "hash"]
    embedding.build_table_cli(["--output", port_path, *args])
    monkeypatch.setattr(sys, "argv", ["embedding", "--output", jax_path, *args])
    jax_embedding.build_table_cli()
    with np.load(port_path) as got, np.load(jax_path) as want:
        assert got["instructions"].tolist() == want["instructions"].tolist()
        assert got["embeddings"].dtype == want["embeddings"].dtype == np.float32
        assert got["embeddings"].tobytes() == want["embeddings"].tobytes()
        sample = want["instructions"][::997].tolist()
    port_reads_jax = embedding.get_embedder(jax_path)
    jax_reads_port = jax_embedding.get_embedder(port_path)
    assert port_reads_jax.name == "table"
    for text in sample:
        assert port_reads_jax(text).tobytes() == jax_reads_port(text).tobytes()
        assert port_reads_jax(text).tobytes() == embedding.HashInstructionEmbedder()(text).tobytes()
    with pytest.raises(KeyError, match="not in embedding table"):
        port_reads_jax("push the table off the robot")
    with pytest.raises(SystemExit, match="N_CHOOSE_K"):
        embedding.build_table_cli(["--output", port_path, "--block_mode", "N_CHOOSE_K"])


# ------------------------------------------------------------- planner plot


def _planner(cls, obstacles, iters):
    return cls(start=(0.2, -0.2), goal=(0.55, 0.25), x_range=(0.15, 0.64),
               y_range=(-0.34, 0.34), obstacle_xy=obstacles,
               obstacle_radii=[0.03] * len(obstacles), delta=0.015, step_length=0.05,
               goal_sample_rate=0.1, search_radius=0.5, iter_max=iters,
               rng=np.random.RandomState(0)).plan()


@pytest.mark.parametrize("case", ["tree", "blank", "default_size", "over_frame"])
def test_planner_plot_matches_jax_byte_for_byte(case):
    obstacles, iters, kwargs = [(0.375, 0.025)], 512, dict(image_size=(180, 320))
    if case == "blank":
        obstacles, iters, kwargs = [], 1, dict(image_size=(180, 320), show_tree=False)
    elif case == "default_size":
        kwargs = {}
    elif case == "over_frame":
        frame = np.random.default_rng(1).integers(0, 256, (180, 320, 3), np.uint8)
        kwargs = dict(image=frame, image_size=(360, 640))
    want = jax_plot.draw_planner(_planner(JaxPlanner, obstacles, iters), **kwargs)
    got = plot.draw_planner(_planner(RRTStarPlanner, obstacles, iters), **kwargs)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_oracle_plan_plot_matches_jax_byte_for_byte():
    from rt1_tpu.envs import LanguageTable as JaxLanguageTable
    from rt1_tpu.envs.oracles import RRTPushOracle as JaxOracle
    from rt1_tpu.envs.rewards import BlockToBlockReward as JaxReward
    from rt1_tpu_torch.envs import LanguageTable
    from rt1_tpu_torch.envs.oracles import RRTPushOracle
    from rt1_tpu_torch.envs.rewards import BlockToBlockReward

    images = {}
    for name, env_cls, oracle_cls, reward, mode, draw in (
            ("jax", JaxLanguageTable, JaxOracle, JaxReward, jax_blocks, jax_plot),
            ("port", LanguageTable, RRTPushOracle, BlockToBlockReward, blocks, plot)):
        env = env_cls(block_mode=mode.BlockMode.BLOCK_4, reward_factory=reward, seed=11,
                      render_text_in_image=False)
        oracle = oracle_cls(env, use_ee_planner=True, seed=0)
        env.reset()
        # One frame for both: the board renderers agree only near-pixel-exactly.
        frame = images.setdefault("frame", env.render())
        images[name] = draw.draw_oracle_plan(oracle, env.compute_state(), image=frame,
                                             image_size=(180, 320))
        images[name + "_blank"] = draw.draw_oracle_plan(oracle, env.compute_state())
    assert images["port"].tobytes() == images["jax"].tobytes()
    assert images["port_blank"].tobytes() == images["jax_blank"].tobytes()


# ------------------------------------------------------------------ overlay


STRIP = 3 * int(360 * 0.08)
LONG = "push the red star to the left of the blue cube, then to the top right corner"


@pytest.mark.parametrize("size", [(180, 320), (64, 114)])
@pytest.mark.parametrize("text", [None, "move the green moon to the red pentagon", LONG])
def test_overlay_layout_matches_jax(size, text):
    frame = np.random.default_rng(2).integers(0, 256, (*size, 3), np.uint8)
    info = {} if text is None else {"instruction": text}
    want = jax_rendering.add_debug_info_to_image(frame, info)
    got = rendering.add_debug_info_to_image(frame, info)
    assert got.shape == want.shape == (360 + STRIP, 640, 3) and got.dtype == np.uint8
    assert got[STRIP:].tobytes() == want[STRIP:].tobytes()
    lines = [] if text is None else __import__("textwrap").wrap("instruction: " + text, 35)
    for canvas in (got, want):
        ink = (canvas[:STRIP] != 255).any(-1)
        rows = np.flatnonzero(ink.any(-1))
        assert (rows.size == 0) == (not lines)
        if lines:  # the text's rows lie in its lines' bands
            assert rows.min() >= 2 and rows.max() < 2 + 14 * len(lines)
            for k in range(len(lines)):
                assert ink[2 + 14 * k:2 + 14 * k + 12].any()
    # The port's own text boxes: 35 characters of 6 pixels, 7 rows a line.
    ink = (got[:STRIP] != 255).any(-1)
    assert not ink[:, 2 + 35 * 6:].any()
    for k in range(len(lines)):
        assert not ink[2 + 14 * k + 7:2 + 14 * (k + 1)].any()


# ------------------------------------------------------------------- videos


def _gif_frames(path):
    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
    return frames


def test_episode_gif_decodes_under_jax_names(tmp_path):
    kwargs = dict(num_evals_per_reward=2, max_episode_steps=6, seed=3, write_videos=True,
                  video_tag="random", env_kwargs=dict(target_height=64, target_width=114,
                                                      sequence_length=3))
    got = evaluate.evaluate_policy(evaluate.RandomEvalPolicy(seed=0), workdir=str(tmp_path / "p"),
                                   block_mode=blocks.BlockMode.BLOCK_4, **kwargs)
    want = jax_evaluate.evaluate_policy(jax_evaluate.RandomEvalPolicy(seed=0),
                                        workdir=str(tmp_path / "j"),
                                        block_mode=jax_blocks.BlockMode.BLOCK_4, **kwargs)
    assert got == want
    port_dir, jax_dir = tmp_path / "p" / "videos_random", tmp_path / "j" / "videos_random"
    port_files, jax_files = sorted(os.listdir(port_dir)), sorted(os.listdir(jax_dir))
    assert [os.path.splitext(n)[0] for n in port_files] == \
        [os.path.splitext(n)[0] for n in jax_files]
    assert all(n.endswith(".gif") for n in port_files) and len(port_files) == 2
    steps = want["mean_episode_length"]["block2block"]
    lengths = []
    for name in port_files:
        frames = _gif_frames(str(port_dir / name))
        assert all(f.shape == (360 + STRIP, 640, 3) for f in frames)
        assert count_gif_frames(str(port_dir / name)) == len(frames)
        lengths.append(len(frames) - 1)
    assert np.mean(lengths) == steps
    for name in jax_files:  # imageio's GIFs (local palettes) walk alike
        if name.endswith(".gif"):
            path = str(jax_dir / name)
            assert count_gif_frames(path) == Image.open(path).n_frames
    with pytest.raises(ValueError):
        write_gif(str(tmp_path / "none.gif"), [])


def test_write_gif_within_the_palette_tolerance(tmp_path):
    from rt1_tpu_torch.envs import LanguageTable
    from rt1_tpu_torch.envs.rewards import BlockToBlockReward

    env = LanguageTable(block_mode=blocks.BlockMode.BLOCK_8, reward_factory=BlockToBlockReward,
                        seed=5)
    env.reset()
    rng = np.random.default_rng(0)
    frames = [env.render()]
    for _ in range(12):
        env.step(rng.uniform(-0.03, 0.03, 2).astype(np.float32))
        frames.append(env.render())
    path = write_gif(str(tmp_path / "episode.gif"), frames, fps=10)
    decoded = _gif_frames(path)
    assert len(decoded) == len(frames)
    err = np.abs(np.stack(decoded).astype(np.int32) - np.stack(frames)).max(-1)
    assert (err == 0).mean() >= GIF_EXACT_SHARE
    assert err.mean() < GIF_MEAN_ERR and err.max() <= GIF_MAX_ERR
    im = Image.open(path)
    assert im.info.get("duration") == 100 and im.info.get("loop") == 0


# ------------------------------------------------------- closed-loop diagnostics


def _jax_script_loop():
    """`main` and `_block_target_distance` of `scripts/policy_diagnostics.py`,
    compiled from the script's source alone (importing it would register
    its flags and the learning proof's)."""
    path = os.path.join(REPO, "scripts", "policy_diagnostics.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    nodes = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name in ("main", "_block_target_distance")]
    namespace = {"np": np, "os": os, "json": json}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), path, "exec"), namespace)
    return namespace


def test_closed_loop_diagnostics_match_jax(tmp_path, monkeypatch):
    from test_torch_eval import _cv2_crop_resize_batch, _tiny_pair

    # Both policies see the same frames (the port's wrapper resizes with
    # cv2 here, as in tests/test_torch_eval.py).
    monkeypatch.setattr(wrappers, "crop_resize_batch", _cv2_crop_resize_batch)
    h, w = 64, 114
    jm, variables, policy = _tiny_pair(seed=13, h=h, w=w)
    out = str(tmp_path / "jax_diagnostics.json")
    namespace = _jax_script_loop()
    namespace["FLAGS"] = types.SimpleNamespace(
        workdir=str(tmp_path), corpus_entropy=False, block_mode="BLOCK_4", diag_seed=20_000,
        embedder="hash", height=h, width=w, seq_len=3, diag_episodes=2, max_steps=6, out=out)
    namespace["learn_proof"] = types.SimpleNamespace(
        REWARD="block2block", EVAL_META_KEYS=(), _check_train_meta=lambda *_: None,
        _restore_policy=lambda *_: JaxRT1EvalPolicy(jm, variables))
    namespace["main"]([])
    with open(out) as f:
        want = json.load(f)
    env = evaluate.build_eval_env(reward_name="block2block", block_mode=blocks.BlockMode.BLOCK_4,
                                  seed=20_000, embedder="hash", target_height=h,
                                  target_width=w, sequence_length=3)
    got = diagnostics.closed_loop_diagnostics(RT1EvalPolicy(policy), env, 2, 6)
    assert sorted(got) == sorted(want)
    assert len(got["per_episode"]) == 2
    for g, w_ in zip([got] + got["per_episode"], [want] + want["per_episode"]):
        assert sorted(g) == sorted(w_)
        for key, value in w_.items():
            if key == "per_episode":
                continue
            if isinstance(value, float):
                assert abs(g[key] - value) <= ACTION_TOL, key
            else:
                assert g[key] == value, key


# ----------------------------------------------------------------- encoders


@pytest.mark.parametrize("variant", ["float32", "bfloat16", "chunked"])
def test_flax_msgpack_encoder_loads_bit_for_bit_and_grafts(tmp_path, monkeypatch, variant):
    import flax.serialization

    from test_torch_pretrain_graft import H, TOL, W, _policy_pair
    from test_torch_pretrain_vision import _jax_model, _jax_variables

    if variant == "chunked":  # flax splits arrays over this many bytes into chunks
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    variables = _jax_variables(_jax_model(), 6)
    if variant == "bfloat16":
        variables = jax.tree_util.tree_map(lambda x: np.asarray(x).astype(jax.numpy.bfloat16),
                                           variables)
    path = str(tmp_path / "enc.msgpack")
    jax_pv.save_encoder(variables, {"val_rmse": 0.1, "history": []}, path)
    with open(path, "rb") as f:
        raw = f.read()
    if variant == "chunked":
        assert b"__msgpack_chunked_array__" in raw
    enc = jax_pv.load_encoder(path)
    want = state_dict_from_flax(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                                       enc["params"]),
                                jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                                       enc["batch_stats"]))
    loaded = pv.load_encoder(path)
    assert loaded["format"] == pv.FLAX_ENCODER_FORMAT
    assert sorted(loaded["state_dict"]) == sorted(want)
    for key, value in want.items():
        assert loaded["state_dict"][key].dtype == value.dtype
        assert loaded["state_dict"][key].numpy().tobytes() == value.numpy().tobytes(), key
    tree = flax_msgpack.restore(raw)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        flax.serialization.msgpack_restore(raw))
    # The grafted policies step alike.
    jm, policy_vars, pm, _ = _policy_pair(seed=5)
    grafted = jax_pv.graft_encoder_into_policy(policy_vars, enc)
    assert pv.graft_encoder_into_policy(pm, loaded) is pm
    jax_step = jax.jit(lambda v, o, s: jm.apply(v, o, s, method=jm.infer_step))
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((2, 512)).astype(np.float32)
    jstate, pstate = jm.initial_state(2), pm.initial_state(2)
    for step in range(jm.time_sequence_length + 1):
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


def test_flax_msgpack_reader_decodes_each_type():
    import msgpack

    tree = {"i": [0, 127, -32, -33, 255, 65535, 2**32, -2**40], "f": [1.5, -2.25e300],
            "s": "x" * 40, "b": b"\x00\x01" * 200, "n": None, "t": True, "e": False,
            "m": {str(k): k for k in range(20)}, "a": list(range(20))}
    assert flax_msgpack.loads(msgpack.packb(tree, use_bin_type=True)) == tree
    with pytest.raises(ValueError):
        flax_msgpack.loads(msgpack.packb(tree) + b"\x00")


# ---------------------------------------------------------- perception probe


def _jax_arms_and_report_keys():
    path = os.path.join(REPO, "scripts", "perception_probe.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    arms = next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "ARMS")
    keys = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Subscript) and isinstance(n.value, ast.Dict))
    return arms, {k.value for k in keys.value.keys}


def test_perception_probe_keeps_jax_arms_and_report(tmp_path, capsys):
    arms, keys = _jax_arms_and_report_keys()
    assert perception_probe.ARMS == arms
    out_dir = str(tmp_path / "probe")
    args = ["--out_dir", out_dir, "--frames", "16", "--steps", "2", "--batch", "4", "--arms",
            "small_64x96", "--device", "cpu"]
    assert perception_probe.main(args) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(out_dir, "probe_results.json")) as f:
        arm = json.load(f)["small_64x96"]
    assert keys <= set(arm) and set(summary["small_64x96"]) == set(arm) - {"history"}
    assert arm["resolution"] == [64, 96] and np.isfinite(arm["val_rmse_mm"])
    _, _, names = jax_pv.generate_state_regression_dataset(2, image_hw=(64, 96))
    assert arm["target_names"] == names
    encoder = pv.load_encoder(arm["encoder_path"])
    assert encoder["width_coefficient"] == 0.35
    assert perception_probe.main(args) == 0  # a recorded arm is skipped
    assert '"status": "already_recorded"' in capsys.readouterr().out
