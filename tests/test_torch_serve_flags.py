"""The replica's batcher flags (`python -m rt1_tpu_torch.serve --max_batch
--max_delay_ms --max_queue --pipeline_depth --request_timeout_s
--verbose`), on the CPU with the tiny config.

* `ServeApp`'s settings reach the batcher of both schedulers: the
  continuous scheduler takes `max_delay_s` as its coalesce cap, the cycle
  scheduler as its deadline.
* The defaults are JAX's: the serve CLI's flag defaults (read from
  `rt1_tpu/serve/__main__.py`) and `ServeApp`'s; `max_batch` 0 or None is
  `max_sessions` and a larger value is clamped to it, as the JAX app
  clamps it on a JAX engine.
* Through the CLI: `/healthz` reports the flags as they took, and with
  `--max_queue 1` a burst of requests gets 503 `busy` (retry true) beside
  200s; `--verbose` logs a line per request.
* A burst of 24 POSTs, connecting before the accept loop runs, is
  answered in full by the replica's, the stub's and the router's HTTP
  server (`serve/httpd.py`: socketserver's backlog of 5 resets some).
"""

import ast
import base64
import inspect
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from rt1_tpu.serve.engine import PolicyEngine as JaxPolicyEngine
from rt1_tpu.serve.server import ServeApp as JaxServeApp
from rt1_tpu.specs import language_table_action_space as jax_action_space
from rt1_tpu.specs import sample_space
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.serve.__main__ import parse_args
from rt1_tpu_torch.serve.batcher import ContinuousBatcher, MicroBatcher
from rt1_tpu_torch.serve.engine import PolicyEngine, pow2_buckets
from rt1_tpu_torch.serve.server import ServeApp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 56
FLAGS = ("max_batch", "max_delay_ms", "max_queue", "pipeline_depth", "request_timeout_s",
         "verbose")
APP_KEYS = ("max_batch", "max_delay_s", "max_queue", "pipeline_depth", "request_timeout_s")


def _engine(max_sessions=4):
    policy = build_policy(get_config("tiny"), attention_impl="fused")
    return PolicyEngine(policy, max_sessions=max_sessions, buckets=pow2_buckets(max_sessions))


def _jax_engine(max_sessions=4):
    jcfg = jax_tiny.get_config()
    jm = jax_build_model(jcfg.model)
    t = jcfg.model.time_sequence_length
    obs = {"image": np.zeros((1, t, H, W, 3), np.float32),
           "natural_language_embedding": np.zeros((1, t, 512), np.float32)}
    key = jax.random.PRNGKey(0)
    actions = sample_space(jax_action_space(), key, (1, t))
    variables = jm.init({"params": key, "crop": key}, obs, actions)
    return JaxPolicyEngine(jm, variables, max_sessions=max_sessions)


@pytest.mark.parametrize("scheduler", ["continuous", "cycle"])
def test_flags_reach_the_batcher(scheduler):
    app = ServeApp(_engine(), image_shape=(H, W, 3), scheduler=scheduler, max_batch=2,
                   max_delay_s=0.003, max_queue=5, pipeline_depth=3, request_timeout_s=7.0)
    batcher = app.batcher
    assert app.request_timeout_s == 7.0
    assert batcher._max_batch == 2 and batcher._max_queue == 5
    if scheduler == "continuous":
        assert isinstance(batcher, ContinuousBatcher)
        assert batcher._pipeline_depth == 3 and batcher._WORKERS == 3
        assert batcher._coalesce_s == 0.003
    else:
        assert isinstance(batcher, MicroBatcher) and not isinstance(batcher, ContinuousBatcher)
        assert batcher._max_delay_s == 0.003


def _jax_flag_defaults():
    """{flag: default} of the JAX serve CLI's `flags.DEFINE_*` calls."""
    with open(os.path.join(REPO, "rt1_tpu", "serve", "__main__.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "").startswith("DEFINE_") \
                and len(node.args) >= 2 and isinstance(node.args[0], ast.Constant):
            out[node.args[0].value] = ast.literal_eval(node.args[1])
    return out


def test_defaults_and_clamp_equal_jax():
    jax_flags = _jax_flag_defaults()
    args = parse_args(["--config", "tiny", "--random_init"])
    for flag in FLAGS:
        assert getattr(args, flag) == jax_flags[flag], flag
    ours = inspect.signature(ServeApp.__init__).parameters
    theirs = inspect.signature(JaxServeApp.__init__).parameters
    for key in APP_KEYS:
        assert ours[key].default == theirs[key].default, key

    engine, jax_engine = _engine(4), _jax_engine(4)
    for max_batch, want in ((None, 4), (0, 4), (3, 3), (100, 4)):
        app = ServeApp(engine, image_shape=(H, W, 3), max_batch=max_batch)
        jax_app = JaxServeApp(jax_engine, image_shape=(H, W, 3), max_batch=max_batch)
        assert app.batcher._max_batch == jax_app.batcher._max_batch == want, max_batch
        assert app.max_batch == want


def _post(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_cli_flags_take_and_a_full_queue_answers_busy(tmp_path):
    errlog = open(tmp_path / "stderr.txt", "w+")  # noqa: SIM115 - closed below
    proc = subprocess.Popen(
        [sys.executable, "-m", "rt1_tpu_torch.serve", "--config", "tiny", "--random_init",
         "--port", "0", "--device", "cpu", "--max_sessions", "2", "--max_batch", "100",
         "--max_delay_ms", "4", "--max_queue", "1", "--pipeline_depth", "1",
         "--request_timeout_s", "9", "--verbose"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=errlog, text=True)
    try:
        ready = None
        for line in proc.stdout:
            if line.startswith("{") and '"serving"' in line:
                ready = json.loads(line)
                break
        assert ready is not None, "no ready line"
        url = f"http://127.0.0.1:{ready['port']}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["batcher"] == {"max_batch": 2, "max_delay_s": 0.004, "max_queue": 1,
                                     "pipeline_depth": 1, "request_timeout_s": 9.0}
        frame = np.zeros((H, W, 3), np.uint8)
        image = base64.b64encode(frame.tobytes()).decode()
        replies = []
        lock = threading.Lock()

        def act(i):
            body = {"session_id": f"s{i % 2}", "image_b64": image,
                    "instruction": "push the red moon to the blue cube"}
            reply = _post(url + "/act", body)
            with lock:
                replies.append(reply)

        threads = [threading.Thread(target=act, args=(i,)) for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        codes = [code for code, _ in replies]
        assert len(codes) == 24 and set(codes) <= {200, 503}
        assert codes.count(200) >= 2
        busy = [body for code, body in replies if code == 503]
        assert busy and all(body["retry"] is True and body["error"] == "busy" for body in busy)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        errlog.seek(0)
        log = errlog.read()
        errlog.close()
    assert '"POST /act HTTP/1.1" 200' in log


@pytest.mark.parametrize("server", ["replica", "stub", "router"])
def test_a_burst_of_connects_is_answered(server):
    from rt1_tpu_torch.serve import router as router_mod
    from rt1_tpu_torch.serve import stub as stub_mod
    from rt1_tpu_torch.serve.httpd import HTTPServer
    from rt1_tpu_torch.serve.server import make_server

    if server == "replica":
        httpd = make_server(ServeApp(_engine(2), image_shape=(H, W, 3)))
    elif server == "stub":
        httpd = stub_mod.make_stub_server(stub_mod.StubReplicaApp())
    else:
        httpd = router_mod.make_router_server(router_mod.Router(replica_timeout_s=5.0))
    assert isinstance(httpd, HTTPServer)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/act"
    body = json.dumps({"session_id": "s", "pad": "x" * 1000}).encode()  # refused, answered
    codes = []

    def post():
        try:
            with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                        timeout=60) as resp:
                code = resp.status
        except urllib.error.HTTPError as exc:
            code = exc.code
        except OSError as exc:
            code = repr(exc)
        codes.append(code)

    threads = [threading.Thread(target=post) for _ in range(24)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.5)  # every connect waits in the listen queue
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        for t in threads:
            t.join(60)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert len(codes) == 24 and all(isinstance(c, int) for c in codes), codes
