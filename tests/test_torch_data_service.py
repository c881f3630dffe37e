"""The port's data service (`rt1_tpu_torch/data/service.py`) held against
the JAX package's RLDS pipeline through TF's tf.data service: TF's
`DispatchServer` and `WorkerServer` in this process, the port's dispatcher
in this process and its workers in this process or as processes, all on
ephemeral ports. The same seeded episodes, and the committed TFDS fixture,
go through both sides. Eval batches are held exact (bit for bit, images
included); training streams by their multiset of windows. Every socket,
join and queue wait has its own deadline, and every server and process is
stopped in a `finally`.
"""

import collections
import contextlib
import json
import os
import select
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tfds_language_table")
READY_S = 120   # a worker process's start (python, numpy, torch)
EVAL_KW = dict(window=3, crop_factor=0.95, height=16, width=24, batch_size=2)


def _tf():
    return pytest.importorskip("tensorflow")


def _episode(t, h=30, w=40, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.integers(0, 255, (t, h, w, 3), dtype=np.uint8),
            "instruction": rng.normal(size=(t, d)).astype(np.float32),
            "action": rng.uniform(-0.1, 0.1, (t, 2)).astype(np.float32),
            "is_first": np.array([True] + [False] * (t - 1)),
            "is_terminal": np.array([False] * (t - 1) + [True])}


def _episodes():
    return [_episode(t, seed=t) for t in (5, 9, 4)]


def _key(batch):
    return tuple(np.asarray(batch[g][k]).tobytes() for g in ("observations", "actions")
                 for k in sorted(batch[g]))


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for group in ("observations", "actions"):
            assert sorted(a[group]) == sorted(b[group])
            for k in b[group]:
                assert a[group][k].dtype == b[group][k].dtype, k
                np.testing.assert_array_equal(a[group][k], b[group][k], err_msg=k)


def _drain(stream):
    try:
        return list(stream)
    finally:
        stream.close()


@contextlib.contextmanager
def tf_service(workers=1):
    """TF's dispatcher and `workers` workers in this process."""
    from tensorflow.data.experimental.service import (DispatchServer, DispatcherConfig,
                                                      WorkerConfig, WorkerServer)

    dispatcher = DispatchServer(DispatcherConfig(port=0))
    servers = []
    try:
        for _ in range(workers):
            servers.append(WorkerServer(WorkerConfig(
                dispatcher_address=dispatcher.target.split("://")[1], port=0)))
        yield dispatcher.target
    finally:
        for server in servers:
            server.stop()
        dispatcher.stop()


@contextlib.contextmanager
def port_service(workers=1):
    """The port's dispatcher and `workers` workers in this process."""
    from rt1_tpu_torch.data import service

    dispatcher = service.DispatchServer()
    servers = []
    try:
        for _ in range(workers):
            servers.append(service.WorkerServer(service.WorkerConfig(dispatcher.target)))
        yield dispatcher.target
    finally:
        for server in servers:
            server.stop()
        dispatcher.stop()
        assert dispatcher.join(timeout=10)


@contextlib.contextmanager
def worker_processes(target, n, tmp_path):
    """`n` workers of `python -m rt1_tpu_torch.data.service worker`, each
    (process, ready record) once it has registered."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, logs = [], []
    try:
        for i in range(n):
            logs.append(open(tmp_path / f"worker_{i}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "rt1_tpu_torch.data.service", "worker",
                 "--dispatcher_address", target], cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=logs[-1], text=True))
        ready = []
        for proc in procs:
            readable, _, _ = select.select([proc.stdout], [], [], READY_S)
            assert readable, f"no ready line from worker {proc.pid} within {READY_S} s"
            ready.append(json.loads(proc.stdout.readline()))
            assert ready[-1]["status"] == "ready" and ready[-1]["role"] == "worker"
        yield list(zip(procs, ready))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for proc in procs:
            proc.wait(timeout=30)
            proc.stdout.close()
        for log in logs:
            log.close()


def _jax_eval(J, eps, target, **kw):
    return list(J.windowed_rlds_dataset(
        J.make_episode_dataset_from_arrays(eps),
        J.RldsPipelineConfig(**kw, data_service_address=target), training=False)
        .as_numpy_iterator())


def _fixture_eval_episodes(tf, J, split):
    """The fixture's `split` as JAX's graph converts it (JAX's own TFDS
    front-end needs tensorflow_datasets): the hash embedder's vector."""
    from rt1_tpu.eval.embedding import get_embedder
    from rt1_tpu_torch.data import tfds

    host = get_embedder("hash")

    def embed(text):
        return tf.numpy_function(lambda s: host(np.asarray(s).item().decode("utf-8")),
                                 [text], tf.float32)

    def to_tf(tree):
        return {k: to_tf(v) if isinstance(v, dict) else tf.constant(v) for k, v in tree.items()}

    d = tfds.TfdsDirectory(os.path.join(FIXTURE, "png"))
    return [{k: v.numpy() for k, v in J.rlds_episode_to_tensors(
        to_tf(e["steps"].dense()), embed).items()} for e in d.episodes(split)]


@pytest.mark.parametrize("source", ["episodes", "fixture"])
def test_one_worker_eval_equals_jax_through_tf_service(source):
    """Eval through one worker: JAX's order, batch for batch, exactly."""
    tf = _tf()
    from rt1_tpu.data import rlds_pipeline as J
    from rt1_tpu_torch.data import rlds_pipeline as P

    kw = dict(EVAL_KW, height=32, width=56) if source == "fixture" else EVAL_KW
    with port_service() as ours_at, tf_service() as theirs_at:
        cfg = P.RldsPipelineConfig(**kw, data_service_address=ours_at)
        if source == "episodes":
            eps = _episodes()
            ours = _drain(P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps), cfg,
                                                  training=False))
        else:
            streams = P.create_rlds_datasets(os.path.join(FIXTURE, "png"), cfg,
                                             splits=("train[:1]", "train[1:]"))
            streams[0].close()
            assert streams[1].job_name == "rt1_tpu_train/train[1:]"
            ours = _drain(streams[1])
            eps = _fixture_eval_episodes(tf, J, "train[1:]")
        theirs = _jax_eval(J, eps, theirs_at, **kw)
    _assert_batches_equal(ours, theirs)


def test_two_workers_eval_yields_every_window_twice():
    """Sharding OFF: each worker runs the whole pass; the multiset equals
    JAX's through two TF workers, each worker's batches in JAX's order."""
    _tf()
    from rt1_tpu.data import rlds_pipeline as J
    from rt1_tpu_torch.data import rlds_pipeline as P

    eps = _episodes()
    with port_service(workers=2) as ours_at, tf_service(workers=2) as theirs_at:
        stream = P.windowed_rlds_dataset(
            P.make_episode_dataset_from_arrays(eps),
            P.RldsPipelineConfig(**EVAL_KW, data_service_address=ours_at), training=False)
        ours = _drain(stream)
        theirs = _jax_eval(J, eps, theirs_at, **EVAL_KW)
    one_pass = _drain(P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps),
                                              P.RldsPipelineConfig(**EVAL_KW), training=False))
    assert len(ours) == len(theirs) == 2 * len(one_pass)
    assert sorted(map(_key, ours)) == sorted(map(_key, theirs))
    # In turn, while both serve: worker 0's batches, then worker 1's.
    _assert_batches_equal(ours[0::2], one_pass)
    _assert_batches_equal(ours[1::2], one_pass)
    assert [w["batches"] for w in stream.workers()] == [len(one_pass)] * 2


def test_two_workers_training_streams_differ_and_hold_jaxs_windows():
    """Training through two workers: each worker's windows are JAX's
    training multiset; worker 0 sends the in-process stream of the seed,
    worker 1 that of `worker_seed(seed, 1)`, so no two send one stream."""
    _tf()
    from rt1_tpu.data import rlds_pipeline as J
    from rt1_tpu_torch.data import rlds_pipeline as P
    from rt1_tpu_torch.data import service

    eps = [_episode(t, h=12, w=16, seed=10 + t) for t in (5, 3, 6, 2, 4)]
    kw = dict(window=2, crop_factor=None, height=12, width=16, batch_size=1, repeat=False,
              shuffle_buffer=7, seed=3)
    with port_service(workers=2) as ours_at, tf_service(workers=2) as theirs_at:
        ours = _drain(P.windowed_rlds_dataset(
            P.make_episode_dataset_from_arrays(eps),
            P.RldsPipelineConfig(**kw, data_service_address=ours_at), training=True))
        theirs = list(J.windowed_rlds_dataset(
            J.make_episode_dataset_from_arrays(eps),
            J.RldsPipelineConfig(**kw, data_service_address=theirs_at), training=True)
            .as_numpy_iterator())
        one_tf = list(J.windowed_rlds_dataset(
            J.make_episode_dataset_from_arrays(eps), J.RldsPipelineConfig(**kw),
            training=True).as_numpy_iterator())
    windows = sum((5, 3, 6, 2, 4))
    assert len(ours) == len(theirs) == 2 * windows
    assert sorted(map(_key, ours)) == sorted(map(_key, theirs))
    w0, w1 = [list(map(_key, ours[i::2])) for i in (0, 1)]
    assert sorted(w0) == sorted(w1) == sorted(map(_key, one_tf))
    assert w0 != w1

    def local(seed):
        return [_key(b) for b in _drain(P.windowed_rlds_dataset(
            P.make_episode_dataset_from_arrays(eps), P.RldsPipelineConfig(**dict(kw, seed=seed)),
            training=True))]

    assert w0 == local(3)
    assert service.worker_seed(3, 1) != 3 and w1 == local(service.worker_seed(3, 1))


def test_two_consumers_of_one_job_split_its_output():
    """Job sharing, as TF's: two consumers of one job name read each
    worker's pass once between them, and neither is starved."""
    _tf()
    from rt1_tpu.data import rlds_pipeline as J
    from rt1_tpu_torch.data import rlds_pipeline as P

    eps = _episodes()
    kw = dict(EVAL_KW, batch_size=1, data_service_job_name="shared")

    def alternate(first, second):
        got, live = ([], []), [first, second]
        while any(s is not None for s in live):
            for i, s in enumerate(live):
                if s is not None:
                    try:
                        got[i].append(next(s))
                    except StopIteration:
                        live[i] = None
        return got

    with port_service(workers=2) as ours_at, tf_service(workers=2) as theirs_at:
        cfg = P.RldsPipelineConfig(**kw, data_service_address=ours_at)
        a, b = (P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps), cfg,
                                        training=False) for _ in range(2))
        try:
            assert a.job_id == b.job_id
            ours = alternate(a, b)
        finally:
            a.close()
            b.close()
        jcfg = J.RldsPipelineConfig(**kw, data_service_address=theirs_at)
        theirs = alternate(*(J.windowed_rlds_dataset(J.make_episode_dataset_from_arrays(eps),
                                                     jcfg, training=False).as_numpy_iterator()
                             for _ in range(2)))
    one_pass = _drain(P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps),
                                              P.RldsPipelineConfig(**dict(EVAL_KW, batch_size=1)),
                                              training=False))
    want = sorted(map(_key, one_pass)) * 2
    assert sorted(map(_key, ours[0] + ours[1])) == sorted(want)
    assert sorted(map(_key, theirs[0] + theirs[1])) == sorted(want)
    assert ours[0] and ours[1]


@pytest.mark.parametrize("differs", ["source", "config", "mode"])
def test_a_mismatched_consumer_raises(differs):
    """A second consumer of a job name with another source, config or
    mode raises (TF 2.21's reads nothing, without an error); the job's own
    stream goes on."""
    from rt1_tpu_torch.data import rlds_pipeline as P

    eps = _episodes()
    with port_service() as at:
        cfg = P.RldsPipelineConfig(**EVAL_KW, data_service_address=at, data_service_job_name="j")
        first = P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps), cfg,
                                        training=False)
        try:
            other_eps, other_cfg, training = eps, cfg, False
            if differs == "source":
                other_eps = eps[:2]
            elif differs == "config":
                other_cfg = P.RldsPipelineConfig(**dict(EVAL_KW, batch_size=1),
                                                 data_service_address=at,
                                                 data_service_job_name="j")
            else:
                training = True
            with pytest.raises(ValueError, match="runs another source, config or mode"):
                P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(other_eps), other_cfg,
                                        training=training)
            assert len(list(first)) == 9  # (5 + 9 + 4) windows / 2
        finally:
            first.close()


@pytest.mark.parametrize("case", ["grpc", "no_port", "unreachable", "no_worker",
                                  "worker_unreachable"])
def test_refusals(case, monkeypatch):
    """An address of another protocol raises at once; an unreachable
    dispatcher, or a job with no worker, raises within the deadline."""
    import socket

    from rt1_tpu_torch.data import rlds_pipeline as P
    from rt1_tpu_torch.data import service

    if case in ("grpc", "no_port"):
        address = "grpc://localhost:5000" if case == "grpc" else "localhost"
        with pytest.raises(ValueError, match="its own protocol" if case == "grpc"
                           else "not tcp://host:port"):
            P.RldsPipelineConfig(data_service_address=address)
        return
    monkeypatch.setattr(service, "DEADLINE_S", 1.5)
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("localhost", 0))
        closed = f"tcp://localhost:{s.getsockname()[1]}"
    eps = P.make_episode_dataset_from_arrays(_episodes())
    t0 = time.monotonic()
    if case == "unreachable":
        with pytest.raises(ConnectionError, match="cannot reach the data service"):
            P.windowed_rlds_dataset(eps, P.RldsPipelineConfig(
                **EVAL_KW, data_service_address=closed), training=False)
    elif case == "worker_unreachable":
        with pytest.raises(ConnectionError, match="cannot reach the data service"):
            service.WorkerServer(service.WorkerConfig(closed))
    else:
        with port_service(workers=0) as at:
            stream = P.windowed_rlds_dataset(eps, P.RldsPipelineConfig(
                **EVAL_KW, data_service_address=at), training=False)
            try:
                with pytest.raises(RuntimeError, match="no worker left"):
                    next(stream)
            finally:
                stream.close()
    assert time.monotonic() - t0 < 1.5 + 3.0


def _store_paths(store, split):
    return sorted(os.path.join(store, split, n) for n in os.listdir(os.path.join(store, split)))


def test_a_custom_callable_source_runs_only_beside_its_consumer(rlds_store, tmp_path):
    """A `reader=` function cannot leave this process: a worker process
    refuses it and names the limit; a worker in this process runs it."""
    from rt1_tpu_torch.data import episodes as episodes_lib
    from rt1_tpu_torch.data import rlds_pipeline as P
    from rt1_tpu_torch.data import service

    paths = _store_paths(rlds_store, "val")
    source = P.make_episode_dataset_from_paths(paths, reader=lambda p: episodes_lib.load_episode(p))
    assert source.describe()["kind"] == "local"
    kw = dict(EVAL_KW, height=32, width=56)
    dispatcher = service.DispatchServer()
    try:
        with worker_processes(dispatcher.target, 1, tmp_path):
            stream = P.windowed_rlds_dataset(source, P.RldsPipelineConfig(
                **kw, data_service_address=dispatcher.target), training=False)
            try:
                with pytest.raises(RuntimeError, match="custom callable.*own process"):
                    next(stream)
            finally:
                stream.close()
    finally:
        dispatcher.stop()
    with port_service() as at:
        ours = _drain(P.windowed_rlds_dataset(source, P.RldsPipelineConfig(
            **kw, data_service_address=at), training=False))
    local = _drain(P.windowed_rlds_dataset(P.make_episode_dataset_from_paths(paths),
                                           P.RldsPipelineConfig(**kw), training=False))
    _assert_batches_equal(ours, local)


def _listed_workers(target, expected, within_s=15):
    """The worker indices the dispatcher lists to a new job, polled until
    they are `expected` or `within_s` has passed."""
    from rt1_tpu_torch.data import rlds_pipeline as P

    deadline = time.monotonic() + within_s
    while True:
        cfg = P.RldsPipelineConfig(**EVAL_KW, data_service_address=target,
                                   data_service_job_name=None)
        stream = P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(_episodes()[:1]), cfg,
                                         training=False)
        listed = [w["index"] for w in stream.workers()]
        stream.close()
        if listed == expected or time.monotonic() > deadline:
            return listed
        time.sleep(0.2)


def test_a_killed_worker_drops_out_and_the_stream_ends(tmp_path):
    """Two worker processes; one is killed mid-pass: the stream goes on
    with the other, which sends its whole pass, and ends."""
    from rt1_tpu_torch.data import rlds_pipeline as P
    from rt1_tpu_torch.data import service

    eps = [_episode(t, h=12, w=16, seed=t) for t in (9, 8, 7)]
    kw = dict(window=2, crop_factor=None, height=12, width=16, batch_size=1)
    one_pass = _drain(P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps),
                                              P.RldsPipelineConfig(**kw), training=False))
    dispatcher = service.DispatchServer()
    try:
        with worker_processes(dispatcher.target, 2, tmp_path) as workers:
            (proc0, ready0), (proc1, ready1) = workers
            stream = P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps),
                                             P.RldsPipelineConfig(
                                                 **kw, data_service_address=dispatcher.target),
                                             training=False)
            try:
                got = [next(stream) for _ in range(4)]  # two from each, in turn
                proc1.send_signal(signal.SIGKILL)
                proc1.wait(timeout=30)
                got += list(stream)
                stats, workers_seen = stream.stats(), stream.workers()
            finally:
                stream.close()
            assert (stats["workers_ended"], stats["workers_dropped"]) == (1, 1)
            assert stats["batches"] == stats["received"] == len(got)
            by_index = {w["index"]: w for w in workers_seen}
            assert by_index[ready0["index"]]["state"] == "ended"
            assert by_index[ready1["index"]]["state"] == "dropped"
            assert by_index[ready0["index"]]["batches"] == len(one_pass)
            assert 2 <= by_index[ready1["index"]]["batches"] < len(one_pass)
            assert len(got) == len(one_pass) + by_index[ready1["index"]]["batches"]
            counts = collections.Counter(map(_key, got))
            assert set(counts) == set(map(_key, one_pass))
            # The dispatcher dropped it too: a new job lists one worker.
            assert _listed_workers(dispatcher.target, [ready0["index"]]) == [ready0["index"]]
            assert service.worker_stats(ready0["target"])["cuda_initialized"] is False
    finally:
        dispatcher.stop()


def test_a_hung_worker_times_out_and_drops_out(tmp_path, monkeypatch):
    """A worker process that stops answering (SIGSTOP): the consumer drops
    it after BATCH_TIMEOUT_S and ends on the other's pass; the dispatcher
    forgets it after WORKER_TIMEOUT_S without a heartbeat."""
    from rt1_tpu_torch.data import rlds_pipeline as P
    from rt1_tpu_torch.data import service

    monkeypatch.setattr(service, "BATCH_TIMEOUT_S", 3.0)
    monkeypatch.setattr(service, "WORKER_TIMEOUT_S", 3.0)
    eps = [_episode(t, h=12, w=16, seed=t) for t in (9, 8, 7)]
    kw = dict(window=2, crop_factor=None, height=12, width=16, batch_size=1)
    one_pass = _drain(P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps),
                                              P.RldsPipelineConfig(**kw), training=False))
    dispatcher = service.DispatchServer()
    try:
        with worker_processes(dispatcher.target, 2, tmp_path) as workers:
            (_, ready0), (proc1, ready1) = workers
            stream = P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps),
                                             P.RldsPipelineConfig(
                                                 **kw, data_service_address=dispatcher.target),
                                             training=False)
            try:
                got = [next(stream) for _ in range(4)]
                proc1.send_signal(signal.SIGSTOP)
                t0 = time.monotonic()
                got += list(stream)
                seconds = time.monotonic() - t0
                states = {w["index"]: w for w in stream.workers()}
            finally:
                stream.close()
            assert states[ready1["index"]]["state"] == "dropped"
            assert states[ready0["index"]]["batches"] == len(one_pass)
            assert len(got) == len(one_pass) + states[ready1["index"]]["batches"]
            assert seconds < 3.0 + 15
            assert _listed_workers(dispatcher.target, [ready0["index"]]) == [ready0["index"]]
    finally:
        dispatcher.stop()


def test_many_consumers_share_a_job_under_thread_pressure():
    """Eight consumer threads on one job of two workers, the interpreter
    switching threads every 10 us: every batch of each worker's pass goes
    to exactly one consumer."""
    import threading

    from rt1_tpu_torch.data import rlds_pipeline as P

    eps = _episodes()
    kw = dict(EVAL_KW, batch_size=1, data_service_job_name="stress")
    one_pass = _drain(P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps),
                                              P.RldsPipelineConfig(**dict(EVAL_KW, batch_size=1)),
                                              training=False))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with port_service(workers=2) as at:
            cfg = P.RldsPipelineConfig(**kw, data_service_address=at)
            streams = [P.windowed_rlds_dataset(P.make_episode_dataset_from_arrays(eps), cfg,
                                               training=False) for _ in range(8)]
            got = [[] for _ in streams]
            threads = [threading.Thread(target=lambda s=s, out=out: out.extend(s))
                       for s, out in zip(streams, got)]
            try:
                for thread in threads:
                    thread.start()
                for thread in threads:
                    thread.join(timeout=60)
                assert not any(thread.is_alive() for thread in threads)
            finally:
                for stream in streams:
                    stream.close()
    finally:
        sys.setswitchinterval(interval)
    assert len({s.job_id for s in streams}) == 1
    union = sorted(_key(b) for out in got for b in out)
    assert union == sorted(list(map(_key, one_pass)) * 2)


# ---------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def rlds_store(tmp_path_factory):
    from rt1_tpu_torch.data import convert_rlds

    root = tmp_path_factory.mktemp("rlds_store")
    convert_rlds.convert(os.path.join(FIXTURE, "png"), str(root), num_train=2, num_val=1,
                         num_test=0)
    return str(root)


def test_each_batch_rank_runs_a_job_of_its_own(rlds_store):
    """Two batch ranks (blocks 0 and 1 of 2) on one dispatcher: each reads
    its own `paths[block::2]` through a job of its own, its first batch
    that of its block in this process; under one job name, as JAX names
    them, the second rank's stream is refused."""
    import dataclasses

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.data import rlds_pipeline as P
    from rt1_tpu_torch.train.train import dataset_batches

    cfg = get_config("tiny")
    cfg.data.data_dir, cfg.data.loader = rlds_store, "rlds_tf"
    d = cfg.data
    pcfg = P.RldsPipelineConfig(window=cfg.model.time_sequence_length, crop_factor=d.crop_factor,
                                height=d.height, width=d.width,
                                batch_size=cfg.per_host_batch_size,
                                shuffle_buffer=d.shuffle_buffer, seed=cfg.seed)
    paths = _store_paths(rlds_store, "train")
    assert len(paths) == 2
    with port_service() as at:
        d.data_service_address = at
        ranks = [dataset_batches(cfg, "train", block=b, blocks=2).batches for b in (0, 1)]
        try:
            assert [r.job_name for r in ranks] == ["rt1_tpu_train/0", "rt1_tpu_train/1"]
            assert ranks[0].job_id != ranks[1].job_id
            firsts = [next(r) for r in ranks]
            one_name = dataclasses.replace(pcfg, data_service_address=at,
                                           data_service_job_name="rt1_tpu_train/0")
            with pytest.raises(ValueError, match="runs another source"):
                P.windowed_rlds_dataset(P.make_episode_dataset_from_paths(paths[1::2]),
                                        one_name, training=True)
        finally:
            for r in ranks:
                r.close()
    for block, first in enumerate(firsts):
        local = P.windowed_rlds_dataset(P.make_episode_dataset_from_paths(paths[block::2]),
                                        pcfg, training=True)
        try:
            _assert_batches_equal([first], [next(local)])
        finally:
            local.close()


def test_trainer_through_the_service_equals_jax_and_trains(rlds_store, tmp_path):
    """`data.loader=rlds_tf` with `data.data_service_address` (workers as
    processes): the first eval batch equals JAX's `rlds_tf` eval batch
    through TF's service, the jobs are named by split, and the CLI trains
    three steps with an eval at each."""
    _tf()
    from rt1_tpu.train import train as jax_train
    from rt1_tpu.train.configs import tiny as jax_tiny
    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.data import service
    from rt1_tpu_torch.train import __main__ as train_main
    from rt1_tpu_torch.train.train import dataset_batches, service_job_name

    assert service_job_name("train", 0, 1) == "rt1_tpu_train"
    assert service_job_name("val", 0, 1) == "rt1_tpu_train/val"
    assert service_job_name("train", 1, 2) == "rt1_tpu_train/1"
    dispatcher = service.DispatchServer()
    try:
        with worker_processes(dispatcher.target, 2, tmp_path) as workers:
            cfg, jcfg = get_config("tiny"), jax_tiny.get_config()
            for key, value in {"data_dir": rlds_store, "loader": "rlds_tf"}.items():
                setattr(cfg.data, key, value)
                jcfg.data[key] = value
            cfg.data.data_service_address = dispatcher.target
            stream = dataset_batches(cfg, "val")
            try:
                assert stream.batches.job_name == "rt1_tpu_train/val"
                ours = next(stream.batches)
            finally:
                stream.batches.close()
            with tf_service() as theirs_at:
                jcfg.data["data_service_address"] = theirs_at
                theirs = next(jax_train.dataset_batches(jcfg, "val"))
            _assert_batches_equal([ours], [theirs])

            workdir = str(tmp_path / "wd")
            args = ["--config", "tiny", "--workdir", workdir, "--device", "cpu",
                    "--set", f"data.data_dir={rlds_store}", "--set", "data.loader=rlds_tf",
                    "--set", f"data.data_service_address={dispatcher.target}",
                    "--set", "num_steps=3", "--set", "eval_every_steps=1",
                    "--set", "checkpoint_every_steps=3"]
            assert train_main.main(args) in (0, None)
            served = [service.worker_stats(ready["target"]) for _, ready in workers]
    finally:
        dispatcher.stop()
    lines = [json.loads(x) for x in open(os.path.join(workdir, "metrics.jsonl"))]
    assert [x["step"] for x in lines if "eval_loss" in x] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in lines if "loss" in x)
    assert os.path.exists(os.path.join(workdir, "checkpoints", "3", "state.pt"))
    # Both workers served, and neither initialised CUDA.
    assert all(s["batches"] > 0 and s["cuda_initialized"] is False for s in served)
