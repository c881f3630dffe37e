"""Distributed RLDS preprocessing: the port's counterpart of
`tf.data.experimental.service`, which the JAX package hands its RLDS
pipeline to when `data_service_address` is set
(`rt1_tpu/data/rlds_pipeline.py:207-222`, `ShardingPolicy.OFF`).

* `DispatchServer` keeps the jobs by name and the workers registered with
  it, and notices a worker that dies (its connection closes, or its
  heartbeat stops for WORKER_TIMEOUT_S).
* `WorkerServer` runs `windowed_rlds_dataset` for each job in its own
  process, from the job's source description
  (`rlds_pipeline.source_from_description`), and serves the batches. It
  never initialises CUDA.
* `DataServiceStream` (what `windowed_rlds_dataset` returns when
  `data_service_address` is set) registers or joins the job, then pulls
  batches from the job's workers in turn, AHEAD of them a worker.

Semantics, tf.data service's with sharding OFF:

* every worker runs the whole pipeline, so an eval pass through 2 workers
  yields each window twice;
* consumers of one job name share its output: each batch goes to one of
  them, and their union is every worker's stream;
* the stream ends when every worker's stream has ended; a worker that dies
  drops out and the stream goes on with the rest. With no worker left, or
  no dispatcher to reach, it raises within DEADLINE_S.

Two differences by design. A training stream on the worker of index k > 0
shuffles and crops from `worker_seed(seed, k)` (the pipeline is
deterministic, so two workers of one seed would send the same batches; TF's
differ only through its non-deterministic interleave); worker 0 keeps the
seed, so one worker sends the in-process stream. A consumer whose source,
config or mode differs from its job's raises, where TF's reads nothing.

Addresses are `tcp://host:port` (or `host:port`); the service speaks its
own protocol, not TF's gRPC. A message is an 8-byte length, a JSON header
and the raw buffers of the arrays it names, received into numpy arrays
allocated for them (`recv_into`); nothing is pickled, and the source
descriptions are data. Like tf.data service, it has no authentication:
run it on a trusted network (it binds localhost unless told otherwise).

    python -m rt1_tpu_torch.data.service dispatcher --port 5050
    python -m rt1_tpu_torch.data.service worker --dispatcher_address host:5050
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
import os
import queue
import signal
import socket
import socketserver
import struct
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

DEADLINE_S = 60.0         # reaching a peer; a job with no worker
BATCH_TIMEOUT_S = 300.0   # a worker's reply to one request (a batch included)
HEARTBEAT_S = 0.5         # a worker's heartbeat to its dispatcher
WORKER_TIMEOUT_S = 10.0   # a worker silent this long is dead
REFRESH_S = 1.0           # a consumer asks for its job's workers this often
AHEAD = 2                 # batches a consumer holds from each worker
_LEN = struct.Struct("!Q")
_MAX_HEADER = 64 << 20
_KINDS = "biuf"           # bool, int, uint, float: the dtypes a message carries


# ------------------------------------------------------------------ wire

def parse_address(address: str) -> Tuple[str, int]:
    """(host, port) of `tcp://host:port` or `host:port`."""
    scheme, sep, rest = address.partition("://")
    if not sep:
        rest = address
    elif scheme != "tcp":
        raise ValueError(
            f"data service address {address!r}: the port's data service speaks its own "
            "protocol over TCP (tcp://host:port), not tf.data service's gRPC; start "
            "`python -m rt1_tpu_torch.data.service dispatcher` and pass its target")
    host, sep, port = rest.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"data service address {address!r} is not tcp://host:port")
    return host, int(port)


def _encode(tree, arrays: List[np.ndarray]):
    if isinstance(tree, dict):
        if "__array__" in tree:
            raise ValueError("'__array__' is a reserved key")
        return {str(k): _encode(v, arrays) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_encode(v, arrays) for v in tree]
    if isinstance(tree, np.ndarray):
        if tree.dtype.kind not in _KINDS:
            raise TypeError(f"cannot send an array of dtype {tree.dtype}")
        arrays.append(np.ascontiguousarray(tree))
        return {"__array__": len(arrays) - 1}
    if isinstance(tree, np.generic):
        return tree.item()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot send a {type(tree).__name__}")


def _decode(body, arrays: List[np.ndarray]):
    if isinstance(body, dict):
        if "__array__" in body:
            return arrays[body["__array__"]]
        return {k: _decode(v, arrays) for k, v in body.items()}
    if isinstance(body, list):
        return [_decode(v, arrays) for v in body]
    return body


def _pack(tree) -> Tuple[bytes, List[np.ndarray]]:
    arrays: List[np.ndarray] = []
    body = _encode(tree, arrays)
    header = json.dumps({"body": body, "arrays": [[a.dtype.str, list(a.shape)] for a in arrays]},
                        sort_keys=True).encode()
    return header, arrays


def fingerprint(tree) -> str:
    """SHA-256 of `tree` as the wire encodes it (its JSON and its arrays'
    bytes): equal trees, equal fingerprints."""
    header, arrays = _pack(tree)
    digest = hashlib.sha256(header)
    for a in arrays:
        digest.update(memoryview(a.reshape(-1)).cast("B"))
    return digest.hexdigest()


def _recv_into(sock: socket.socket, view: memoryview) -> None:
    while view.nbytes:
        n = sock.recv_into(view)
        if n == 0:
            raise ConnectionError("the peer closed the connection")
        view = view[n:]


class Connection:
    """One TCP connection carrying messages: `send(tree)`, `recv()`.
    `recv_s` and `bytes_received` add up the time from a message's first
    byte to its last, and its bytes."""

    def __init__(self, sock: socket.socket, timeout: Optional[float] = None):
        self.sock = sock
        sock.settimeout(timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.recv_s = 0.0
        self.bytes_received = 0

    def send(self, tree) -> None:
        header, arrays = _pack(tree)
        self.sock.sendall(_LEN.pack(len(header)) + header)
        for a in arrays:
            if a.nbytes:
                self.sock.sendall(memoryview(a.reshape(-1)).cast("B"))

    def recv(self):
        head = bytearray(_LEN.size)
        _recv_into(self.sock, memoryview(head))
        t0 = time.perf_counter()
        (n,) = _LEN.unpack(head)
        if n > _MAX_HEADER:
            raise ConnectionError(f"a message header of {n} bytes: not this service's protocol")
        header = bytearray(n)
        _recv_into(self.sock, memoryview(header))
        header = json.loads(header)
        arrays = []
        for dtype, shape in header["arrays"]:
            dtype = np.dtype(dtype)
            if dtype.kind not in _KINDS:
                raise ConnectionError(f"a message array of dtype {dtype}")
            buf = np.empty(shape, dtype)
            if buf.nbytes:
                _recv_into(self.sock, memoryview(buf.reshape(-1)).cast("B"))
            arrays.append(buf)
        self.recv_s += time.perf_counter() - t0
        self.bytes_received += _LEN.size + n + sum(a.nbytes for a in arrays)
        return _decode(header["body"], arrays)

    def request(self, tree):
        self.send(tree)
        return self.recv()

    def settimeout(self, timeout: Optional[float]) -> None:
        self.sock.settimeout(timeout)

    def shutdown(self) -> None:
        """Unblocks a thread waiting on this connection."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def close(self) -> None:
        self.sock.close()


def connect(address: str, timeout: Optional[float] = None) -> Connection:
    """A connection to `address`, retried until DEADLINE_S has passed (a
    peer that is still starting); ConnectionError after it. `timeout`
    bounds each later wait on the connection."""
    host, port = parse_address(address)
    deadline_s = DEADLINE_S
    end = time.monotonic() + deadline_s
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=max(0.1, end - time.monotonic()))
            return Connection(sock, timeout)
        except OSError as exc:
            if time.monotonic() + 0.1 >= end:
                raise ConnectionError(f"cannot reach the data service at {address} within "
                                      f"{deadline_s} s: {exc}") from exc
            time.sleep(0.1)


# ------------------------------------------------------------------ servers

class _TcpServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class _Server:
    """A threaded TCP server whose connections `_serve` handles; `stop()`
    closes them all."""

    def _start_server(self, host: str, port: int, name: str) -> None:
        owner = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                conn = Connection(self.request)
                with owner._lock:
                    owner._conns.add(conn)
                try:
                    owner._serve(conn)
                except OSError:  # the peer went away (ConnectionError, a timeout)
                    pass
                finally:
                    with owner._lock:
                        owner._conns.discard(conn)

        self._conns = set()
        self._stopped = threading.Event()
        self._server = _TcpServer((host, port), Handler)
        self.host, self.port = host, self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": 0.1}, name=name, daemon=True)
        self._thread.start()

    @property
    def target(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    def join(self, timeout: Optional[float] = None) -> bool:
        """Waits until `stop()`; True once stopped."""
        return self._stopped.wait(timeout)

    def _stop_server(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        self._server.shutdown()
        self._server.server_close()
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.shutdown()
        self._thread.join(timeout=10)


@dataclasses.dataclass
class DispatcherConfig:
    port: int = 0
    host: str = "localhost"   # the address it binds (localhost: this host only)


class DispatchServer(_Server):
    """The jobs by name and the live workers (tf.data service's
    `DispatchServer`). A connection's first message makes it a worker's
    (`register_worker`, then heartbeats) or a consumer's (`open_job`, then
    `workers` requests until `release`): a connection that closes is a
    worker that died or a consumer that left."""

    def __init__(self, config: Optional[DispatcherConfig] = None):
        self.config = config or DispatcherConfig()
        self._lock = threading.Lock()
        self._workers: Dict[int, str] = {}       # index -> address
        self._indices = itertools.count()
        self._jobs: Dict[int, Dict] = {}         # id -> {name, fingerprint, consumers}
        self._by_name: Dict[str, int] = {}
        self._next_job = 0
        self._start_server(self.config.host, self.config.port, "rt1-data-dispatcher")

    def stop(self) -> None:
        self._stop_server()

    def _worker_list(self) -> List[Dict]:
        return [{"index": i, "address": a} for i, a in sorted(self._workers.items())]

    def _serve(self, conn: Connection) -> None:
        msg = conn.recv()
        op = msg.get("op")
        if op == "register_worker":
            self._worker_session(conn, msg["address"])
        elif op == "open_job":
            self._consumer_session(conn, msg.get("name"), msg["fingerprint"])
        else:
            conn.send({"error": f"unknown op {op!r}"})

    def _worker_session(self, conn: Connection, address: str) -> None:
        with self._lock:
            index = next(self._indices)
            self._workers[index] = address
        try:
            conn.send({"index": index})
            conn.settimeout(WORKER_TIMEOUT_S)
            while True:
                conn.recv()  # a heartbeat
                with self._lock:
                    reply = {"jobs": sorted(self._jobs), "next_job": self._next_job}
                conn.send(reply)
        finally:
            with self._lock:
                del self._workers[index]

    def _consumer_session(self, conn: Connection, name: Optional[str], print_: str) -> None:
        with self._lock:
            job_id = self._by_name.get(name) if name is not None else None
            if job_id is not None and self._jobs[job_id]["fingerprint"] != print_:
                conn.send({"error": (
                    f"data service job {name!r} runs another source, config or mode than this "
                    "consumer's: consumers join a job only with the same pipeline (tf.data "
                    "service would read nothing here); give this stream a job name of its own "
                    "(data_service_job_name)")})
                return
            if job_id is None:
                job_id = self._next_job
                self._next_job += 1
                self._jobs[job_id] = {"name": name, "fingerprint": print_, "consumers": 0}
                if name is not None:
                    self._by_name[name] = job_id
            self._jobs[job_id]["consumers"] += 1
            workers = self._worker_list()
        released = False
        try:
            conn.send({"job_id": job_id, "workers": workers})
            while True:
                op = conn.recv().get("op")
                if op == "release":
                    self._release(job_id)
                    released = True
                    conn.send({"released": job_id})
                    return
                with self._lock:
                    workers = self._worker_list()
                conn.send({"workers": workers})
        finally:
            if not released:
                self._release(job_id)

    def _release(self, job_id: int) -> None:
        with self._lock:
            job = self._jobs[job_id]
            job["consumers"] -= 1
            if job["consumers"] == 0:
                del self._jobs[job_id]
                if self._by_name.get(job["name"]) == job_id:
                    del self._by_name[job["name"]]


def worker_seed(seed: int, index: int) -> int:
    """The training stream's seed on the worker of `index`: worker 0
    keeps `seed`; the others fold their index in."""
    if index == 0:
        return seed
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


class _WorkerJob:
    """One job's stream on a worker; `next()` is the reply to a consumer's
    request for a batch."""

    def __init__(self, spec: Dict, index: int):
        from rt1_tpu_torch.data import rlds_pipeline

        cfg = rlds_pipeline.RldsPipelineConfig(**spec["config"])
        if spec["training"]:
            cfg.seed = worker_seed(cfg.seed, index)
        source = rlds_pipeline.source_from_description(spec["source"])
        self._stream = rlds_pipeline.windowed_rlds_dataset(source, cfg, spec["training"])
        self._lock = threading.Lock()
        self._last = None  # the end or the error, once reached

    def next(self) -> Dict:
        with self._lock:
            if self._last is None:
                try:
                    batch = next(self._stream)
                except StopIteration:
                    self._last = {"end": True}
                except Exception as exc:  # the pipeline's failure, raised by the consumer
                    self._last = {"error": f"{type(exc).__name__}: {exc}"}
                else:
                    return {"batch": batch}
            return self._last

    def close(self) -> None:
        self._stream.close()


@dataclasses.dataclass
class WorkerConfig:
    dispatcher_address: str
    port: int = 0
    host: str = "localhost"   # the address it binds, and consumers dial


class WorkerServer(_Server):
    """Runs the jobs' pipelines and serves their batches (tf.data
    service's `WorkerServer`). It registers with the dispatcher, takes an
    index there, and heartbeats every HEARTBEAT_S; the reply names the
    live jobs, and a job no consumer holds any more is closed. Without its
    dispatcher it stops (`lost_dispatcher`)."""

    def __init__(self, config: WorkerConfig):
        self.config = config
        self._lock = threading.Lock()
        self._jobs: Dict[int, _WorkerJob] = {}
        self.index: Optional[int] = None
        self.batches_served = 0
        self.lost_dispatcher = False
        self._start_server(config.host, config.port, "rt1-data-worker")
        try:
            self._dispatcher = connect(config.dispatcher_address, timeout=WORKER_TIMEOUT_S)
            self.index = self._dispatcher.request({"op": "register_worker",
                                                   "address": f"{self.host}:{self.port}"})["index"]
        except BaseException:
            self._stop_server()
            raise
        self._heartbeat = threading.Thread(target=self._beat, name="rt1-data-heartbeat",
                                           daemon=True)
        self._heartbeat.start()

    def _beat(self) -> None:
        while not self._stopped.wait(HEARTBEAT_S):
            try:
                reply = self._dispatcher.request({"op": "heartbeat"})
            except OSError as exc:
                if not self._stopped.is_set():
                    self.lost_dispatcher = True
                    print(json.dumps({"status": "dispatcher_lost", "worker": self.index,
                                      "error": str(exc)}), file=sys.stderr, flush=True)
                    self._shut()
                return
            live = set(reply["jobs"])
            with self._lock:
                gone = [j for j in self._jobs if j < reply["next_job"] and j not in live]
                jobs = [self._jobs.pop(j) for j in gone]
            for job in jobs:
                job.close()

    def _serve(self, conn: Connection) -> None:
        msg = conn.recv()
        if msg.get("op") == "stats":
            conn.send(self.stats())
            return
        if msg.get("op") != "open":
            conn.send({"error": f"unknown op {msg.get('op')!r}"})
            return
        job_id = msg["job_id"]
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            try:
                job = _WorkerJob(msg["spec"], self.index)
            except Exception as exc:  # a source it cannot rebuild, a bad config
                conn.send({"error": f"{type(exc).__name__}: {exc}"})
                return
            with self._lock:
                first = self._jobs.setdefault(job_id, job)
            if first is not job:  # another consumer's request made it meanwhile
                job.close()
                job = first
        conn.send({"opened": job_id, "index": self.index})
        while True:
            conn.recv()  # a request for the next batch
            reply = job.next()
            conn.send(reply)
            if "batch" in reply:
                with self._lock:
                    self.batches_served += 1

    def stats(self) -> Dict:
        torch = sys.modules.get("torch")
        with self._lock:
            jobs, batches = sorted(self._jobs), self.batches_served
        return {"index": self.index, "pid": os.getpid(), "jobs": jobs, "batches": batches,
                "cpu_s": time.process_time(),
                "cuda_initialized": bool(torch is not None and torch.cuda.is_initialized())}

    def _shut(self) -> None:
        self._stop_server()
        self._dispatcher.shutdown()
        self._dispatcher.close()
        with self._lock:
            jobs = list(self._jobs.values())
            self._jobs.clear()
        for job in jobs:
            job.close()

    def stop(self) -> None:
        if not self._stopped.is_set():
            self._shut()
            self._heartbeat.join(timeout=10)


# ------------------------------------------------------------------ client

class _Puller:
    """Pulls one worker's batches of a job into a queue of AHEAD: items
    ("batch", b), ("end", None), ("dead", exc) or ("error", exc)."""

    def __init__(self, worker: Dict, job_id: int, spec: Dict, stop: threading.Event):
        self.index, self.address = worker["index"], worker["address"]
        self.state = "live"
        self.batches = 0    # handed to the consumer
        self.received = 0   # received from the worker
        self.wait_s = 0.0   # from a request to its reply's first byte
        self._job_id, self._spec, self._stop = job_id, spec, stop
        self._queue: "queue.Queue" = queue.Queue(maxsize=AHEAD)
        self._conn: Optional[Connection] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"rt1-data-pull-{self.index}")
        self._thread.start()

    @property
    def recv_s(self) -> float:
        return self._conn.recv_s if self._conn else 0.0

    @property
    def bytes(self) -> int:
        return self._conn.bytes_received if self._conn else 0

    def _run(self) -> None:
        try:
            self._conn = connect(self.address, timeout=BATCH_TIMEOUT_S)
            reply = self._conn.request({"op": "open", "job_id": self._job_id, "spec": self._spec})
            if "error" in reply:
                self._put(("error", RuntimeError(f"data service worker {self.address}: "
                                                 f"{reply['error']}")))
                return
            while not self._stop.is_set():
                t0 = time.perf_counter()
                recv0 = self._conn.recv_s
                reply = self._conn.request({"op": "next"})
                self.wait_s += time.perf_counter() - t0 - (self._conn.recv_s - recv0)
                if "batch" in reply:
                    self.received += 1
                    if not self._put(("batch", reply["batch"])):
                        return
                elif "end" in reply:
                    self._put(("end", None))
                    return
                else:
                    self._put(("error", RuntimeError(f"data service worker {self.address}: "
                                                     f"{reply['error']}")))
                    return
        except OSError as exc:  # the worker died, or stopped answering
            if not self._stop.is_set():
                self._put(("dead", exc))
        finally:
            if self._conn is not None:
                self._conn.close()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def take(self):
        try:
            return self._queue.get(timeout=BATCH_TIMEOUT_S + DEADLINE_S)
        except queue.Empty:
            raise TimeoutError(f"data service worker {self.address}: no reply within "
                               f"{BATCH_TIMEOUT_S + DEADLINE_S} s") from None

    def close(self) -> None:
        if self._conn is not None:
            self._conn.shutdown()
        self._thread.join(timeout=10)


class DataServiceStream:
    """The batches of a data-service job (tf.data service's `distribute`
    with sharding OFF): registers or joins the job `job_name` (None: a job
    of its own) at the dispatcher `address`, then takes batches from the
    job's workers in turn. `spec` is the job: {"source": a description,
    "config": the pipeline's fields, "training": bool}; `keep` is held
    alive with the stream (a local source). `close()` releases the job."""

    def __init__(self, address: str, job_name: Optional[str], spec: Dict, keep=None):
        self.address, self.job_name = address, job_name
        self._spec, self._keep = spec, keep
        self._stop = threading.Event()
        self._pullers: Dict[int, _Puller] = {}
        self._turn: List[_Puller] = []
        self._next = 0
        self._done = False
        self._closed = False
        self._ended = 0
        self._session_lock = threading.Lock()
        self._session: Optional[Connection] = connect(address, timeout=DEADLINE_S)
        try:
            reply = self._session.request({"op": "open_job", "name": job_name,
                                           "fingerprint": fingerprint(spec)})
        except OSError:
            self._session.close()
            raise
        if "error" in reply:
            self._session.close()
            raise ValueError(reply["error"])
        self.job_id = reply["job_id"]
        self._add(reply["workers"])
        self._refreshed = time.monotonic()

    def _add(self, workers: List[Dict]) -> None:
        for worker in workers:
            if worker["index"] not in self._pullers:
                puller = _Puller(worker, self.job_id, self._spec, self._stop)
                self._pullers[worker["index"]] = puller
                self._turn.append(puller)

    def _refresh(self) -> bool:
        """Adds the workers the dispatcher lists; False when it cannot be
        reached."""
        self._refreshed = time.monotonic()
        with self._session_lock:
            if self._session is None:
                return False
            try:
                workers = self._session.request({"op": "workers"})["workers"]
            except OSError:
                self._session.close()
                self._session = None
                return False
        self._add(workers)
        return True

    def _await_workers(self) -> None:
        end = time.monotonic() + DEADLINE_S
        reached = True
        while time.monotonic() < end:
            reached = self._refresh()
            if self._turn:
                return
            time.sleep(0.1)
        dropped = sum(p.state == "dropped" for p in self._pullers.values())
        raise RuntimeError(
            f"data service job {self.job_name!r} at {self.address}: no worker left within "
            f"{DEADLINE_S} s ({dropped} dropped"
            + ("" if reached else "; the dispatcher cannot be reached") + ")")

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._done:
                raise StopIteration
            if time.monotonic() - self._refreshed > REFRESH_S:
                self._refresh()
            if not self._turn:
                if self._ended:
                    self._done = True
                    raise StopIteration
                self._await_workers()
                continue
            i = self._next % len(self._turn)
            puller = self._turn[i]
            kind, item = puller.take()
            if kind == "batch":
                puller.batches += 1
                self._next = i + 1
                return item
            self._turn.pop(i)
            self._next = i
            if kind == "end":
                puller.state = "ended"
                self._ended += 1
            elif kind == "dead":
                puller.state = "dropped"
            else:
                puller.state = "failed"
                self._done = True
                raise item

    def stats(self) -> Dict[str, float]:
        """Numeric gauges (the train loop logs a feed's as `feeder/*`):
        batches handed out and received, bytes received, the ms a received
        batch took from its first byte to its last and waited for its
        worker, the workers by state, and the batches of each."""
        pullers = list(self._pullers.values())
        received = sum(p.received for p in pullers)
        per = 1e3 / received if received else 0.0
        out = {"batches": sum(p.batches for p in pullers), "received": received,
               "bytes": sum(p.bytes for p in pullers),
               "recv_ms_per_batch": sum(p.recv_s for p in pullers) * per,
               "reply_wait_ms_per_batch": sum(p.wait_s for p in pullers) * per}
        for state in ("live", "ended", "dropped"):
            out[f"workers_{state}"] = sum(p.state == state for p in pullers)
        for p in pullers:
            out[f"batches_w{p.index}"] = p.batches
        return out

    def workers(self) -> List[Dict]:
        """Each worker of the job this stream knows: index, address, state
        (live | ended | dropped | failed) and the batches it handed out."""
        return [{"index": p.index, "address": p.address, "state": p.state,
                 "batches": p.batches} for p in self._pullers.values()]

    def close(self) -> None:
        """Stops the pulls and releases the job at the dispatcher."""
        if self._closed:
            return
        self._closed = self._done = True
        self._stop.set()
        for puller in self._pullers.values():
            puller.close()
        with self._session_lock:
            if self._session is not None:
                try:
                    self._session.request({"op": "release"})
                except OSError:
                    pass
                self._session.close()
                self._session = None
        self._keep = None


def worker_stats(address: str) -> Dict:
    """A worker's index, pid, live jobs, batches served, its process's CPU
    seconds and whether that process initialised CUDA."""
    conn = connect(address, timeout=DEADLINE_S)
    try:
        return conn.request({"op": "stats"})
    finally:
        conn.close()


# ------------------------------------------------------------------ processes

def serve(role: str, ready=None, **kwargs) -> int:
    """Runs a dispatcher (`role` "dispatcher", DispatcherConfig's fields)
    or a worker ("worker", WorkerConfig's) until SIGTERM or SIGINT. Its
    ready record ({"status": "ready", "role", "target", "index"}) is
    printed as a JSON line, or sent on `ready` (a multiprocessing
    connection). Returns 1 when a worker lost its dispatcher."""
    if role == "dispatcher":
        server = DispatchServer(DispatcherConfig(**kwargs))
    elif role == "worker":
        import torch

        # The map's MAP_THREADS threads are a worker's parallelism; torch's
        # intra-op threads under each would oversubscribe the cores that
        # the trainer's launches share.
        torch.set_num_threads(1)
        server = WorkerServer(WorkerConfig(**kwargs))
    else:
        raise ValueError(f"role must be dispatcher | worker, got {role!r}")
    if threading.current_thread() is threading.main_thread():
        for signum in (signal.SIGTERM, signal.SIGINT):
            signal.signal(signum, lambda *_: server.stop())
    record = {"status": "ready", "role": role, "target": server.target, "pid": os.getpid(),
              "index": getattr(server, "index", None)}
    if ready is None:
        print(json.dumps(record), flush=True)
    else:
        ready.send(record)
    while not server.join(0.5):  # signals are handled between the waits
        pass
    return 1 if getattr(server, "lost_dispatcher", False) else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="The port's data service for the RLDS "
                                     "pipeline (a trusted network only: no authentication).")
    roles = parser.add_subparsers(dest="role", required=True)
    dispatcher = roles.add_parser("dispatcher", help="keeps the jobs and the workers")
    dispatcher.add_argument("--port", type=int, default=0, help="0: an ephemeral port")
    dispatcher.add_argument("--host", default="localhost", help="the address to bind")
    worker = roles.add_parser("worker", help="runs the jobs' pipelines and serves the batches")
    worker.add_argument("--dispatcher_address", required=True, help="host:port of the dispatcher")
    worker.add_argument("--port", type=int, default=0, help="0: an ephemeral port")
    worker.add_argument("--host", default="localhost",
                        help="the address to bind, which consumers dial")
    args = vars(parser.parse_args(argv))
    return serve(args.pop("role"), **args)


if __name__ == "__main__":
    sys.exit(main())
