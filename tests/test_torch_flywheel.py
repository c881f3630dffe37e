"""The port's data flywheel (`rt1_tpu_torch/flywheel/capture.py`, the
`pack_append` fault site in `data/pack.py::append_shard`, the feeder's
`flywheel_stats` and the serve capture hooks) against the JAX package's.

Every case of `tests/test_flywheel.py` runs on each package's modules with
the same seeded episodes and step streams; each run makes that file's
assertions and returns what it observed (manifests, windows, episode
files, counters, exposition text). Tolerance: exact — equal records,
equal arrays, byte-equal text. Where JAX's case drives its own engine, the
port's case drives a `tiny` torch engine and holds the capture it writes
to the frames and tokens it served.
"""

import os
import types

import numpy as np
import pytest

import rt1_tpu.data.collect as jax_collect
import rt1_tpu.data.episodes as jax_episodes
import rt1_tpu.data.feeder as jax_feeder
import rt1_tpu.data.pack as jax_pack
import rt1_tpu.data.pipeline as jax_pipeline
import rt1_tpu.flywheel.capture as jax_capture
import rt1_tpu.obs.prometheus as jax_prometheus
import rt1_tpu.resilience.faults as jax_faults
import rt1_tpu.serve.metrics as jax_metrics
import rt1_tpu_torch.data.collect as port_collect
import rt1_tpu_torch.data.episodes as port_episodes
import rt1_tpu_torch.data.feeder as port_feeder
import rt1_tpu_torch.data.pack as port_pack
import rt1_tpu_torch.data.pipeline as port_pipeline
import rt1_tpu_torch.flywheel.capture as port_capture
import rt1_tpu_torch.obs.prometheus as port_prometheus
import rt1_tpu_torch.resilience.faults as port_faults
import rt1_tpu_torch.serve.metrics as port_metrics

SRC_H, SRC_W = 24, 40
H, W = 16, 28
WINDOW = 3


@pytest.fixture(autouse=True)
def _native_sampler(monkeypatch):
    # The JAX package resizes with cv2 where it finds it (this sandbox has
    # it); the port with the native sampler, which JAX uses without cv2.
    monkeypatch.setenv("RT1_TPU_FORCE_NATIVE_SAMPLER", "1")


def _ns(ep, pack, feeder, capture, faults, collect, pipeline, metrics, prometheus):
    return types.SimpleNamespace(ep=ep, pack=pack, Feeder=feeder.SampleAheadFeeder,
                                 Sink=capture.EpisodeCaptureSink, capture=capture,
                                 faults=faults, collect=collect, pipeline=pipeline,
                                 ServeMetrics=metrics.ServeMetrics, prometheus=prometheus)


JAX = _ns(jax_episodes, jax_pack, jax_feeder, jax_capture, jax_faults, jax_collect, jax_pipeline,
          jax_metrics, jax_prometheus)
PORT = _ns(port_episodes, port_pack, port_feeder, port_capture, port_faults, port_collect,
           port_pipeline, port_metrics, port_prometheus)


def _make_episodes(m, dirpath, n, steps=6, start=0, task=None, seed=0):
    rng = np.random.default_rng(seed + start)
    paths = []
    os.makedirs(str(dirpath), exist_ok=True)
    for i in range(start, start + n):
        p = os.path.join(str(dirpath), f"episode_{i}.npz")
        ep = m.ep.generate_synthetic_episode(rng, num_steps=steps, height=SRC_H, width=SRC_W)
        ep["instruction_text"] = m.ep.encode_instruction_text(f"move {i}")
        if task is not None:
            ep["task"] = m.ep.encode_instruction_text(task)
        m.ep.save_episode(p, ep)
        paths.append(p)
    return paths


def _base_pack(m, tmp):
    paths = _make_episodes(m, tmp / "src", 4, task="block2block")
    out = str(tmp / "packed")
    m.pack.pack_episodes(paths, out, H, W, 0.95)
    return out, paths


def _manifest(m, out):
    """The manifest minus what names the scratch directory or the mtime."""
    man = m.pack.load_manifest(out)
    for e in man["episodes"]:
        e.pop("source", None)
    return man


def _files(out):
    """{name: bytes} of a pack directory (the manifest's source paths and
    mtimes name the scratch directory: compared through `_manifest`)."""
    got = {}
    for name in sorted(os.listdir(out)):
        if name != "pack_manifest.json":
            with open(os.path.join(out, name), "rb") as f:
                got[name] = f.read()
    return got


def _window(w):
    return {k: {kk: np.asarray(vv).tolist() for kk, vv in v.items()} if isinstance(v, dict)
            else np.asarray(v).tolist() for k, v in w.items()}


def _both(case, tmp_path):
    """Run `case` on each package (own scratch dir); the records must match."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    try:
        port = case(PORT, port_dir)
    finally:
        PORT.faults.clear()
    try:
        ref = case(JAX, jax_dir)
    finally:
        JAX.faults.clear()
    assert port == ref


# ------------------------------------------------------------------ format


def case_fresh_pack_is_single_shard(m, tmp):
    out, paths = _base_pack(m, tmp)
    manifest = m.pack.load_manifest(out)
    assert manifest["format_version"] == m.pack.FORMAT_VERSION
    assert manifest["freshness_epoch"] == 0 and len(manifest["shards"]) == 1
    assert manifest["shards"][0]["frames"] == m.pack.FRAMES_NAME
    assert os.path.exists(os.path.join(out, "frames.bin"))
    assert os.path.exists(os.path.join(out, "meta_action.npy"))
    assert m.pack.pack_is_fresh(out, paths, H, W, 0.95)
    return _manifest(m, out), _files(out)


def case_legacy_manifest_loads(m, tmp):
    import json

    out, paths = _base_pack(m, tmp)
    want = [_window(m.pack.PackedEpisodeCache(out, window=WINDOW).get_window(
        i, np.random.default_rng(i))) for i in (0, 7)]
    manifest_path = os.path.join(out, m.pack.MANIFEST_NAME)
    with open(manifest_path) as f:
        manifest = json.load(f)
    manifest["format_version"] = m.pack.LEGACY_FORMAT_VERSION
    manifest.pop("shards")
    manifest.pop("freshness_epoch")
    for e in manifest["episodes"]:
        e.pop("shard")
        e.pop("task", None)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    cache = m.pack.PackedEpisodeCache(out, window=WINDOW)
    assert cache.num_shards == 1 and cache.freshness_epoch == 0
    assert set(cache.tasks) == {"unknown"}
    got = [_window(cache.get_window(i, np.random.default_rng(i))) for i in (0, 7)]
    assert got == want
    assert m.pack.pack_is_fresh(out, paths, H, W, 0.95)
    return got


def case_canonical_task_id(m, _):
    ids = [m.collect.canonical_task_id(x)
           for x in ("block2block", "block1_to_corner", "my_custom_reward", "", None, "x:y")]
    assert ids == ["block2block", "block1_to_corner", "unknown:my_custom_reward",
                   m.collect.UNKNOWN_TASK, m.collect.UNKNOWN_TASK, "unknown:x:y"]
    return ids


def case_unknown_format_rejected(m, tmp):
    import json

    out, _ = _base_pack(m, tmp)
    manifest_path = os.path.join(out, m.pack.MANIFEST_NAME)
    with open(manifest_path) as f:
        manifest = json.load(f)
    manifest["format_version"] = 99
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="pack format 99"):
        m.pack.PackedEpisodeCache(out, window=WINDOW)
    return True


# ------------------------------------------------------------------ append


def case_append_extends_and_carries_task(m, tmp):
    out, paths = _base_pack(m, tmp)
    new = _make_episodes(m, tmp / "staging", 2, steps=5, start=100, task="corner", seed=9)
    manifest = m.pack.append_shard(out, new)
    assert manifest["freshness_epoch"] == 1 and len(manifest["shards"]) == 2
    assert manifest["shards"][1]["frames"] == "frames_00001.bin"
    assert manifest["shards"][1]["appended"] is True
    assert m.pack.pack_is_fresh(out, paths, H, W, 0.95)
    cache = m.pack.PackedEpisodeCache(out, window=WINDOW)
    assert cache.num_shards == 2 and cache.appended_episodes == 2
    assert len(cache.episodes) == 6 and cache.total_steps == 4 * 6 + 2 * 5
    assert cache.tasks[0] == "block2block" and cache.tasks[4] == "corner"
    assert cache.tasks.count("corner") == 2
    src = m.ep.load_episode(new[0])
    t = src["rgb"].shape[0]
    boxes = np.tile(np.array([[0, 0, SRC_H, SRC_W]], np.int32), (t, 1))
    want = m.pipeline.crop_resize_frames(list(src["rgb"]), boxes, cache.packed_h, cache.packed_w)
    np.testing.assert_array_equal(cache.frames(4), want)
    np.testing.assert_array_equal(cache.meta(4)["action"], src["action"])
    return _manifest(m, out), _files(out)


def case_append_dedupes(m, tmp):
    out, paths = _base_pack(m, tmp)
    before = m.pack.load_manifest(out)
    manifest = m.pack.append_shard(out, paths)
    assert manifest["freshness_epoch"] == before["freshness_epoch"]
    assert len(manifest["shards"]) == 1
    return _manifest(m, out)


def case_append_rejects_foreign_geometry(m, tmp):
    out, _ = _base_pack(m, tmp)
    bad = os.path.join(str(tmp), "bad.npz")
    m.ep.save_episode(bad, m.ep.generate_synthetic_episode(
        np.random.default_rng(0), num_steps=4, height=SRC_H + 2, width=SRC_W))
    with pytest.raises(ValueError, match="corpus-wide"):
        m.pack.append_shard(out, [bad])
    return _manifest(m, out)


def case_torn_append_never_corrupts_readers(m, tmp):
    out, paths = _base_pack(m, tmp)
    new = _make_episodes(m, tmp / "staging", 2, start=50, seed=3)
    m.faults.install_from("pack_append@1")
    try:
        with pytest.raises(OSError, match="pack_append") as info:
            m.pack.append_shard(out, new)
    finally:
        m.faults.clear()
    manifest = m.pack.load_manifest(out)
    assert manifest["freshness_epoch"] == 0 and len(manifest["shards"]) == 1
    assert m.pack.verify_shards(out, manifest) == []
    assert m.pack.pack_is_fresh(out, paths, H, W, 0.95)
    torn = _manifest(m, out)
    # The shard files landed before the fault: orphans beside the old manifest.
    orphans = sorted(n for n in os.listdir(out) if "_00001" in n)
    assert orphans
    assert len(m.pack.PackedEpisodeCache(out, window=WINDOW).episodes) == 4
    manifest = m.pack.append_shard(out, new)
    assert manifest["freshness_epoch"] == 1 and len(manifest["shards"]) == 2
    return torn, orphans, str(info.value).split(" in ")[0], _manifest(m, out), _files(out)


def case_pack_status_names_shard(m, tmp):
    out, paths = _base_pack(m, tmp)
    m.pack.append_shard(out, _make_episodes(m, tmp / "staging", 1, start=60, seed=4))
    shard_file = os.path.join(out, "frames_00001.bin")
    with open(shard_file, "r+b") as f:
        f.truncate(10)
    fresh, reason = m.pack.pack_status(out, paths, H, W, 0.95)
    assert not fresh and "frames_00001.bin" in reason
    with pytest.raises(ValueError, match="frames_00001.bin"):
        m.pack.PackedEpisodeCache(out, window=WINDOW)
    os.remove(shard_file)
    fresh2, reason2 = m.pack.pack_status(out, paths, H, W, 0.95)
    assert not fresh2 and "missing" in reason2
    return fresh, fresh2


# ----------------------------------------------------------------- refresh


def case_cache_refresh_in_place(m, tmp):
    out, _ = _base_pack(m, tmp)
    cache = m.pack.PackedEpisodeCache(out, window=WINDOW)
    n0 = len(cache.index)
    assert cache.refresh() is False
    m.pack.append_shard(out, _make_episodes(m, tmp / "staging", 2, start=70, seed=5))
    assert cache.refresh() is True
    assert cache.num_shards == 2 and len(cache.index) > n0 and cache.refreshes == 1
    idx = np.array([0, n0, len(cache.index) - 1])
    images = np.empty((3, WINDOW, H, W, 3), np.uint8)
    embeds = np.empty((3, WINDOW, 512), np.float32)
    terms = np.empty((3, WINDOW), np.int32)
    actions = np.empty((3, WINDOW, 2), np.float32)
    cache.fill_batch(idx, np.random.default_rng(0), images, embeds, terms, actions)
    want = cache.get_window(int(idx[1]), np.random.default_rng(1))
    np.testing.assert_array_equal(embeds[1, -1],
                                  want["observations"]["natural_language_embedding"][-1])
    return n0, len(cache.index), images.tolist(), embeds.tolist(), terms.tolist(), \
        actions.tolist()


def _order(feeder, epoch):
    """Epoch `epoch`'s window order (JAX: `_epoch_order`, port: `_order_for`)."""
    fn = getattr(feeder, "_epoch_order", None) or feeder._order_for
    return fn(epoch)


def _batch(b):
    return {"image": np.asarray(b["observations"]["image"]).tolist(),
            "action": np.asarray(b["actions"]["action"]).tolist()}


def case_append_then_sample_determinism(m, tmp):
    out, _ = _base_pack(m, tmp)
    feeder_a = m.Feeder(m.pack.PackedEpisodeCache(out, window=WINDOW), 4, seed=11,
                        refresh_at_epoch=True, start=False)
    bpe0 = feeder_a.batches_per_epoch
    epoch0 = [_batch(feeder_a._assemble(t)) for t in range(bpe0)]
    m.pack.append_shard(out, _make_episodes(m, tmp / "staging", 2, start=80, seed=7))
    assert feeder_a._locate(bpe0) == (1, 0)
    n1 = feeder_a._epochs[1]["batches"]
    assert n1 > bpe0
    got = [_batch(feeder_a._assemble(bpe0 + i)) for i in range(3)]
    feeder_b = m.Feeder(m.pack.PackedEpisodeCache(out, window=WINDOW), 4, seed=11,
                        refresh_at_epoch=True, start=False)
    b1_first = feeder_b._firsts[0] + feeder_b._epochs[0]["batches"]
    assert feeder_b._locate(b1_first) == (1, 0)
    assert [_batch(feeder_b._assemble(b1_first + i)) for i in range(3)] == got
    entry0 = feeder_a._epochs[0]
    order0 = entry0["order"].copy()
    entry0["order"] = None
    np.testing.assert_array_equal(_order(feeder_a, 0), order0)
    return epoch0, got, n1, order0.tolist()


def case_feeder_midrun_pickup_threads(m, tmp):
    out, _ = _base_pack(m, tmp)
    cache = m.pack.PackedEpisodeCache(out, window=WINDOW)
    with m.Feeder(cache, 4, seed=2, num_epochs=3, num_threads=1, depth=1,
                  refresh_at_epoch=True) as f:
        bpe0 = f.batches_per_epoch
        got = [next(f), next(f)]
        assert len(got) == 2
        m.pack.append_shard(out, _make_episodes(m, tmp / "staging", 2, start=90, seed=8))
        total = 2 + sum(1 for _ in f)
    bpe1 = len(cache.index) // 4
    assert bpe1 > bpe0 and total == bpe0 + 2 * bpe1
    stats = f.flywheel_stats()
    assert stats["shards"] == 2 and stats["appended_episodes"] == 2
    assert stats["refreshes"] == 1 and stats["corpus_windows"] == 36
    stats.pop("staleness_s")  # wall clock
    return total, stats


# ----------------------------------------------------------------- capture


def _frame(seed=0):
    return np.random.default_rng(seed).random((SRC_H, SRC_W, 3)).astype(np.float32)


def _embedding(seed=0):
    return np.random.default_rng(seed).standard_normal(512).astype(np.float32)


def _drive_session(sink, sid, steps=3, task=None, terminate_last=False, embedding=True,
                   instruction=None):
    for j in range(steps):
        sink.record_step(sid, image=_frame(j), action=[0.01, -0.02], action_tokens=[3, 4],
                         embedding=_embedding(1) if embedding else None,
                         instruction=instruction, task=task,
                         terminate=terminate_last and j == steps - 1)


def _episodes(m, directory):
    """{file index: {key: array as list}} of the capture files in write
    order (names carry the pid and a random token, so compare contents)."""
    names = sorted(f for f in os.listdir(directory) if f.endswith(".npz"))
    names.sort(key=lambda n: n.rsplit("_", 1)[-1])
    out = []
    for n in names:
        with np.load(os.path.join(directory, n)) as ep:
            out.append({k: (str(ep[k].dtype), ep[k].tolist()) for k in sorted(ep.files)})
    return out


def case_capture_writes_packable_episode(m, tmp):
    cap = str(tmp / "cap")
    sink = m.Sink(cap, embed_fn=None)
    _drive_session(sink, "s1", steps=4, task="corner")
    assert sink.finalize("s1", "released")
    files = [f for f in os.listdir(cap) if f.endswith(".npz")]
    ep = m.ep.load_episode(os.path.join(cap, files[0]))
    m.ep.validate_episode(ep)
    assert ep["rgb"].shape == (4, SRC_H, SRC_W, 3) and ep["rgb"].dtype == np.uint8
    assert not ep["is_terminal"].any()
    assert m.ep.decode_instruction_text(ep["task"]) == "corner"
    assert m.ep.decode_instruction_text(ep["outcome"]) == "released"
    paths = _make_episodes(m, tmp / "src", 2, task="block2block")
    out = str(tmp / "packed")
    m.pack.pack_episodes(paths, out, H, W, 0.95)
    manifest = m.pack.append_shard(out, [os.path.join(cap, f) for f in files])
    assert manifest["freshness_epoch"] == 1
    assert m.pack.PackedEpisodeCache(out, window=WINDOW).tasks[2] == "corner"
    return _episodes(m, cap), _manifest(m, out)


def case_capture_terminate_and_eviction(m, tmp):
    cap = str(tmp / "cap")
    sink = m.Sink(cap)
    _drive_session(sink, "t", steps=3, terminate_last=True)
    assert sink.open_sessions == 0
    _drive_session(sink, "e", steps=2)
    sink.record_step("e", image=_frame(9), action=[0.0, 0.0], embedding=_embedding(1),
                     session_started=True)
    assert sink.episodes_total == 2
    eps = _episodes(m, cap)
    assert {bytes(np.asarray(e["outcome"][1], np.uint8)).decode() for e in eps} == {
        "terminated", "evicted"}
    return eps, sink.stats()


def case_capture_bounds(m, tmp):
    cap = str(tmp / "cap")
    sink = m.Sink(cap, max_episodes=2, max_steps=3, max_open_sessions=2)
    _drive_session(sink, "long", steps=5)
    sink.finalize("long", "released")
    assert sink.dropped_steps_total == 2
    _drive_session(sink, "a", steps=2)
    _drive_session(sink, "b", steps=2)
    _drive_session(sink, "c", steps=2)
    assert sink.open_sessions == 2
    sink.finalize("b", "released")
    sink.finalize("c", "released")
    assert len([f for f in os.listdir(cap) if f.endswith(".npz")]) == 2
    assert sink.pruned_total >= 1
    sink.record_step("short", image=_frame(0), action=[0, 0], embedding=_embedding(0))
    assert not sink.finalize("short", "released")
    assert sink.dropped_episodes_total >= 1
    return _episodes(m, cap), sink.stats()


def case_capture_embeds_text_and_write_fault(m, tmp):
    calls = []

    def embed(text):
        calls.append(text)
        return np.full((512,), 0.5, np.float32)

    sink = m.Sink(str(tmp / "cap"), embed_fn=embed)
    _drive_session(sink, "txt", steps=3, embedding=False, instruction="push the moon")
    assert sink.finalize("txt", "released")
    assert calls == ["push the moon"]
    m.faults.install_from("capture_write@2")
    try:
        _drive_session(sink, "t2", steps=3, embedding=False, instruction="push the moon")
        assert not sink.finalize("t2", "released")
    finally:
        m.faults.clear()
    assert sink.write_errors_total == 1 and sink.episodes_total == 1
    bare = m.Sink(str(tmp / "cap2"))
    _drive_session(bare, "x", steps=3, embedding=False, instruction="hi")
    assert not bare.finalize("x", "released")
    assert bare.dropped_episodes_total == 1
    return _episodes(m, str(tmp / "cap")), sink.stats(), bare.stats()


def case_sweep_captures(m, tmp):
    r0, r1 = str(tmp / "replica_0"), str(tmp / "replica_1")
    staging = str(tmp / "staging")
    for i, d in enumerate((r0, r1)):
        sink = m.Sink(d)
        _drive_session(sink, f"s{i}", steps=3)
        sink.finalize(f"s{i}", "released")
    open(os.path.join(r0, ".tmp_episode_junk.npz"), "wb").close()
    moved = m.capture.sweep_captures([r0, r1], staging)
    assert moved == 2
    assert len([f for f in os.listdir(staging) if f.endswith(".npz")]) == 2
    assert m.capture.sweep_captures([r0, r1], staging) == 0
    return moved, sorted(os.listdir(r0)), len(m.capture.capture_files(staging))


def case_capture_gauges_render(m, tmp):
    sink = m.Sink(str(tmp / "cap"))
    _drive_session(sink, "s", steps=3, task="play")
    sink.finalize("s", "released")
    text = m.ServeMetrics().prometheus_text(**sink.stats())
    for line in ("# TYPE rt1_serve_capture_episodes_total counter",
                 "rt1_serve_capture_episodes_total 1", "rt1_serve_capture_steps_total 3",
                 "# TYPE rt1_serve_capture_open_sessions gauge", "rt1_serve_capture_enabled 1"):
        assert line in text
    return [line for line in text.splitlines() if "capture" in line]


def case_flywheel_gauges_render(m, tmp):
    out, _ = _base_pack(m, tmp)
    feeder = m.Feeder(m.pack.PackedEpisodeCache(out, window=WINDOW), 4, seed=0, start=False)
    stats = feeder.flywheel_stats()
    stats["staleness_s"] = 0.0  # wall clock
    text = m.prometheus.render_scalar_gauges(stats, prefix="rt1_flywheel_")
    for name in ("rt1_flywheel_shards", "rt1_flywheel_freshness_epoch",
                 "rt1_flywheel_corpus_windows", "rt1_flywheel_corpus_steps",
                 "rt1_flywheel_appended_episodes", "rt1_flywheel_staleness_s",
                 "rt1_flywheel_refreshes"):
        assert f"# TYPE {name} gauge" in text
    assert "rt1_flywheel_shards 1" in text and "rt1_flywheel_corpus_steps 24" in text
    return text


def case_same_stream_same_episode_files(m, tmp):
    """One seeded stream of served steps (frames float and uint8, tokens,
    embeddings or text, tasks, a terminate, an eviction, a reset) through
    each package's sink: the same files, key for key and array for array."""
    rng = np.random.default_rng(123)
    sink = m.Sink(str(tmp / "cap"), embed_fn=lambda text: np.full((512,), len(text), np.float32))
    for step in range(40):
        sid = f"s{rng.integers(0, 3)}"
        frame = rng.random((SRC_H, SRC_W, 3)).astype(np.float32)
        if step % 3 == 0:
            frame = (frame * 255).astype(np.uint8)
        sink.record_step(
            sid, image=frame, action=rng.standard_normal(2).astype(np.float32),
            action_tokens=rng.integers(0, 256, 3),
            embedding=_embedding(step) if step % 2 else None,
            instruction=f"push {sid}", task="probe" if step % 5 else None,
            session_started=step == 20, terminate=step == 33)
        if step == 25:
            sink.finalize(sid, "reset")
    sink.drain()
    return _episodes(m, str(tmp / "cap")), sink.stats()


CASES = [
    case_fresh_pack_is_single_shard, case_legacy_manifest_loads, case_canonical_task_id,
    case_unknown_format_rejected, case_append_extends_and_carries_task, case_append_dedupes,
    case_append_rejects_foreign_geometry, case_torn_append_never_corrupts_readers,
    case_pack_status_names_shard, case_cache_refresh_in_place,
    case_append_then_sample_determinism, case_feeder_midrun_pickup_threads,
    case_capture_writes_packable_episode, case_capture_terminate_and_eviction,
    case_capture_bounds, case_capture_embeds_text_and_write_fault, case_sweep_captures,
    case_capture_gauges_render, case_flywheel_gauges_render, case_same_stream_same_episode_files,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[len("case_"):] for c in CASES])
def test_flywheel_matches_jax(case, tmp_path):
    _both(case, tmp_path)


# ----------------------------------------------------- the serve capture


def test_serve_capture_opt_in_off_is_bit_identical(tmp_path):
    """The port's ServeApp over a `tiny` engine on the CPU: with capture
    OFF nothing is written and the served tokens equal a capture-ON app's
    over the same engine and frames; ON, `/release` writes an episode whose
    frames and tokens are the ones served, with the task id."""
    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.eval.restore import build_serve_engine
    from rt1_tpu_torch.serve.server import ServeApp

    config = get_config("tiny")
    engine, _ = build_serve_engine(config, device="cpu", max_sessions=4)
    shape = (config.data.height, config.data.width, 3)
    rng = np.random.default_rng(0)
    frames = [rng.random(shape).astype(np.float32) for _ in range(4)]
    cap_dir = str(tmp_path / "cap")
    app_off = ServeApp(engine, image_shape=shape)
    app_on = ServeApp(engine, image_shape=shape, capture=PORT.Sink(cap_dir, min_steps=2))

    def drive(app, sid, task=None):
        tokens = []
        for frame in frames:
            result = app.act(sid, {"image": frame, "natural_language_embedding": _embedding(1)},
                             task=task)
            tokens.append([int(x) for x in result["action_tokens"]])
            assert not result.get("terminate_episode"), "the tiny engine terminated early"
        return tokens

    app_off.start(warmup=False)
    app_on.start(warmup=False)
    try:
        tokens_off = drive(app_off, "plain")
        app_off.release("plain")
        tokens_on = drive(app_on, "captured", task="corner")
        app_on.release("captured")
    finally:
        app_off.drain(timeout=10)
        app_on.drain(timeout=10)
    assert tokens_off == tokens_on
    assert app_off._engine_gauges()["capture_enabled"] == 0
    assert "capture_episodes_total" not in app_off._engine_gauges()
    (name,) = [f for f in os.listdir(cap_dir) if f.endswith(".npz")]
    ep = PORT.ep.load_episode(os.path.join(cap_dir, name))
    assert ep["rgb"].shape == (4,) + shape
    assert PORT.ep.decode_instruction_text(ep["task"]) == "corner"
    assert PORT.ep.decode_instruction_text(ep["outcome"]) == "released"
    np.testing.assert_array_equal(
        ep["rgb"][0], np.clip(np.rint(frames[0] * 255.0), 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(ep["action_tokens"], tokens_on)
    gauges = app_on._engine_gauges()
    assert (gauges["capture_enabled"], gauges["capture_episodes_total"],
            gauges["capture_steps_total"]) == (1, 1, 4)
