"""The port's serving engine and HTTP server, on the CPU with the tiny config.

Engine: two sessions that start at different steps go through
`PolicyEngine.act_batch` together (so one batched step carries rows at two
window phases) and must equal per-session JAX `infer_step` runs on the same
variables and frames, through the window roll (the JAX side runs the
Pallas kernel in interpret mode, the port its fused path's plain version). Server: port 0, `/healthz`,
`/act` with `image_b64` and an instruction, `/reset`, and the JSON
`/metrics` carrying the attention kernel's launch counter. The engine's
action de-normalisation (mean, std, limits): at its defaults the actions
of a fixed +-0.03 clip, bitwise; elsewhere the JAX engine's within 1e-6.
"""

import base64
import json
import threading
import urllib.request

import jax
import numpy as np
import torch

from rt1_tpu.specs import language_table_action_space as jax_action_space
from rt1_tpu.specs import sample_space
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.convert import load_flax_variables
from rt1_tpu_torch.eval.embedding import get_embedder
from rt1_tpu_torch.eval.restore import build_policy, build_serve_engine
from rt1_tpu_torch.serve.engine import PolicyEngine, pow2_buckets
from rt1_tpu_torch.serve.server import ServeApp, make_server

torch.set_num_threads(2)

H, W = 32, 56


def _jax_tiny(seed):
    jcfg = jax_tiny.get_config()
    jm = jax_build_model(jcfg.model).clone(attention_impl="pallas", pallas_interpret=True)
    t = jcfg.model.time_sequence_length
    obs = {"image": np.zeros((1, t, H, W, 3), np.float32),
           "natural_language_embedding": np.zeros((1, t, 512), np.float32)}
    key = jax.random.PRNGKey(0)
    actions = sample_space(jax_action_space(), key, (1, t))
    shapes = jax.eval_shape(lambda k: jm.init({"params": k, "crop": k}, obs, actions), key)
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32), shapes
    )
    return jm, variables


def test_engine_staggered_sessions_match_per_session_jax():
    jm, variables = _jax_tiny(seed=21)
    policy = build_policy(get_config("tiny"), attention_impl="fused")
    load_flax_variables(policy, variables["params"])
    engine = PolicyEngine(policy, max_sessions=4, buckets=pow2_buckets(4))
    jax_step = jax.jit(lambda v, o, s: jm.apply(v, o, s, method=jm.infer_step))

    rng = np.random.default_rng(0)
    sessions = {"a": 0, "b": 2}  # session -> engine step at which it starts
    emb = {sid: rng.standard_normal(512).astype(np.float32) for sid in sessions}
    jstate = {sid: jm.initial_state(1) for sid in sessions}
    steps = jm.time_sequence_length + 4
    for step in range(steps):
        items, expected = [], {}
        for sid, start in sessions.items():
            if step < start:
                continue
            frame = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
            items.append((sid, {"image": frame, "natural_language_embedding": emb[sid]}))
            out, jstate[sid] = jax_step(
                variables,
                {"image": frame[None], "natural_language_embedding": emb[sid][None]},
                jstate[sid],
            )
            expected[sid] = out
        results = engine.act_batch(items)
        for (sid, _), result in zip(items, results):
            ref = expected[sid]
            np.testing.assert_array_equal(result["action_tokens"], np.asarray(ref["action_tokens"])[0],
                                          err_msg=f"{sid} step {step}")
            np.testing.assert_allclose(
                result["action"], np.clip(np.asarray(ref["action"])[0], -0.03, 0.03), atol=1e-6
            )
            assert result["session_started"] == (step == sessions[sid])
            state = engine.session_state(sid)
            assert int(state["seq_idx"]) == int(jstate[sid]["seq_idx"])
            np.testing.assert_array_equal(state["action_tokens"], np.asarray(jstate[sid]["action_tokens"])[0])
    assert engine.compile_count == len(engine.buckets) == 3
    # Warm-up runs every bucket once, then one batched step per act_batch.
    assert engine.steps_total == len(engine.buckets) + steps


def test_engine_denormalisation_defaults_keep_actions():
    """At their defaults (mean 0, std 1, limits -0.03 / 0.03) the engine's
    de-normalisation fields give the actions of the fixed +-0.03 clip,
    bitwise; other values give the JAX engine's actions within 1e-6."""
    from rt1_tpu.serve.engine import PolicyEngine as JaxPolicyEngine

    jm, variables = _jax_tiny(seed=5)
    policy = build_policy(get_config("tiny"), attention_impl="fused")
    load_flax_variables(policy, variables["params"])
    engine = PolicyEngine(policy, max_sessions=1)
    assert (engine.action_mean, engine.action_std, engine.action_minimum,
            engine.action_maximum) == (0.0, 1.0, -0.03, 0.03)
    custom = dict(action_mean=0.01, action_std=3.0, action_minimum=-0.05, action_maximum=0.02)
    scaled = PolicyEngine(policy, max_sessions=1, **custom)
    jax_engine = JaxPolicyEngine(jm, variables, max_sessions=1, **custom)
    rng = np.random.default_rng(2)
    emb = rng.standard_normal(512).astype(np.float32)
    state = policy.initial_state(1)
    for step in range(jm.time_sequence_length + 2):
        frame = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        obs = {"image": frame, "natural_language_embedding": emb}
        with torch.no_grad():
            out, state = policy.infer_step(
                {k: torch.from_numpy(v[None]) for k, v in obs.items()}, state)
        raw = out["action"].numpy()[0]
        got = engine.act("s", obs)["action"]
        assert got.dtype == np.float32
        assert got.tobytes() == np.clip(raw, -0.03, 0.03).astype(np.float32).tobytes(), step
        np.testing.assert_allclose(scaled.act("s", obs)["action"],
                                   jax_engine.act("s", obs)["action"], rtol=0, atol=1e-6)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_server_act_reset_metrics():
    config = get_config("tiny")
    engine, step = build_serve_engine(config, device="cpu", max_sessions=2,
                                      buckets=pow2_buckets(2), embedder=get_embedder("hash"))
    assert step == -1
    app = ServeApp(engine, image_shape=(H, W, 3))
    app.start(warmup=True)
    httpd = make_server(app, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, health = _get(url + "/healthz")
        assert code == 200 and health["image_shape"] == [H, W, 3]
        assert health["compile_count"] == 2
        frame = np.random.default_rng(0).integers(0, 256, (H, W, 3), dtype=np.uint8)
        body = {"session_id": "s1", "image_b64": base64.b64encode(frame.tobytes()).decode(),
                "instruction": "push the red star to the blue cube"}
        for i in range(4):
            code, out = _post(url + "/act", body)
            assert code == 200
            assert out["session_started"] == (i == 0)
            assert len(out["action"]) == 2 and all(-0.03 <= a <= 0.03 for a in out["action"])
            assert len(out["action_tokens"]) == 3 and "request_id" in out
        code, out = _post(url + "/reset", {"session_id": "s1"})
        assert code == 200 and out["ok"] and "slot" in out
        code, metrics = _get(url + "/metrics")
        assert code == 200 and metrics["requests_total"] == 4
        # On the CPU the fused path runs the plain version: no kernel launches.
        assert metrics["attention_launches_total"] == 0
        for variant in ("tensor_core", "tf32x3", "simple"):
            assert metrics[f"attention_launches_{variant}_total"] == 0
        # Warm-up: both buckets on each of the 2 batcher worker threads.
        assert metrics["engine_steps_total"] == engine.steps_total == 2 * 2 + 4
        assert metrics["resets_total"] == 1
        code, ready = _get(url + "/readyz")
        assert code == 200 and ready["ready"]
    finally:
        app.drain()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def _serve_cli(args):
    """`python -m rt1_tpu_torch.serve` with `args` on the CPU, port 0:
    (its ready line, /act of one frame) then SIGTERM; the exit code must
    be 0."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-m", "rt1_tpu_torch.serve", "--config", "tiny",
                             "--device", "cpu", "--port", "0", *args], cwd=repo,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        frame = np.zeros((H, W, 3), np.uint8)
        code, out = _post(f"http://127.0.0.1:{ready['port']}/act",
                          {"session_id": "c3", "instruction": "push the red star",
                           "image_b64": base64.b64encode(frame.tobytes()).decode()})
    finally:
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    return ready, code


def test_serve_cli_refuses_a_checkpoint_of_another_embedder(tmp_path):
    """ROADMAP C3, as the JAX serve CLI guards it (`rt1_tpu/serve/
    __main__.py:92-104`): a `--workdir` whose `data_manifest.json` says
    `ngram` refuses `--embedder hash`, naming the manifest and the flag;
    `--allow_embedder_mismatch` serves it; `--random_init` reads no
    manifest."""
    import os
    import subprocess
    import sys

    import pytest

    from rt1_tpu_torch.serve.__main__ import main

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wd = str(tmp_path / "wd")
    subprocess.run([sys.executable, "-m", "rt1_tpu_torch.train", "--config", "tiny",
                    "--workdir", wd, "--device", "cpu", "--set", "num_steps=2",
                    "--set", "eval_every_steps=0"], cwd=repo, check=True,
                   capture_output=True, timeout=300)
    with open(os.path.join(wd, "data_manifest.json"), "w") as f:
        json.dump({"embedder": "ngram"}, f)
    with pytest.raises(ValueError, match="data_manifest.*allow_embedder_mismatch"):
        main(["--config", "tiny", "--workdir", wd, "--device", "cpu", "--port", "0"])
    with pytest.raises(ValueError, match="'ngram' but 'hash'"):
        main(["--config", "tiny", "--workdir", wd, "--device", "cpu", "--embedder", "hash"])
    ready, code = _serve_cli(["--workdir", wd, "--allow_embedder_mismatch"])
    assert ready["status"] == "serving" and ready["checkpoint_step"] == 2 and code == 200
    ready, code = _serve_cli(["--workdir", wd, "--embedder", "ngram"])
    assert ready["checkpoint_step"] == 2 and code == 200
    ready, code = _serve_cli(["--random_init"])
    assert ready["checkpoint_step"] == -1 and code == 200
