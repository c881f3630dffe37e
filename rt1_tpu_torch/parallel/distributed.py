"""The multi-process runtime (counterpart of `rt1_tpu/parallel/distributed.py`).

One process is one rank of a `torch.distributed` world and drives one
device, as one JAX process drives one host. Before any device is touched
the ranks rendezvous: `initialize_from_config` calls
`torch.distributed.init_process_group` with the coordinator's address,
this rank and the world size. The backend follows the device: NCCL for a
CUDA device (`cuda:LOCAL_RANK`), gloo for `--device cpu`. There is no
fallback: a CUDA world with more ranks on a host than the host has GPUs,
a CUDA device without NCCL, or a rendezvous with nothing to go on raises
before `init_process_group`.

Config (`config.parallel.distributed`):

* ``enabled``             — off (default) keeps the one-process path.
* ``coordinator_address`` — "host:port" of rank 0 (or an init-method URL,
  `tcp://...` or `file://...`).
* ``process_id`` / ``num_processes`` — this rank and the world size;
  ``-1`` defers to the environment.

Environment fallbacks, in order: ``RT1_COORDINATOR`` / ``RT1_PROCESS_ID``
/ ``RT1_NUM_PROCESSES``, then the launcher's (`python -m
torch.distributed.run`) ``MASTER_ADDR:MASTER_PORT`` / ``RANK`` /
``WORLD_SIZE``, where JAX reads ``JAX_COORDINATOR_ADDRESS`` /
``JAX_PROCESS_ID`` / ``JAX_NUM_PROCESSES``. "Enabled with nothing set" is
JAX's TPU-metadata path; here it is valid only under the launcher, whose
environment then fills all three.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
from typing import Any, Optional

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DistributedOptions:
    """Resolved `config.parallel.distributed` (environment fallbacks applied)."""

    enabled: bool = False
    coordinator_address: Optional[str] = None
    process_id: Optional[int] = None
    num_processes: Optional[int] = None
    # The address came from the launcher's MASTER_ADDR:MASTER_PORT, whose
    # agent already serves the rendezvous store there (joined by env://).
    from_launcher: bool = False

    @classmethod
    def from_config(cls, config: Any) -> "DistributedOptions":
        from rt1_tpu_torch.parallel.plan import _get

        block = _get(_get(config, "parallel"), "distributed")
        if block is None:
            return cls()
        enabled = bool(_get(block, "enabled", False))
        addr = _get(block, "coordinator_address") or _env_str("RT1_COORDINATOR")
        from_launcher = addr is None and _launcher_address() is not None
        if from_launcher:
            addr = _launcher_address()
        pid = _int_or_none(_get(block, "process_id", -1))
        if pid is None:
            pid = _env_int("RT1_PROCESS_ID", "RANK")
        count = _int_or_none(_get(block, "num_processes", -1))
        if count is None:
            count = _env_int("RT1_NUM_PROCESSES", "WORLD_SIZE")
        return cls(enabled=enabled, coordinator_address=addr, process_id=pid,
                   num_processes=count, from_launcher=from_launcher)

    def validate(self) -> None:
        """Fail at the config seam: a half-specified rendezvous waits in
        the handshake instead of failing, so partial settings are refused
        here with the missing field named, as JAX's are."""
        if not self.enabled:
            return
        explicit = [
            self.coordinator_address is not None,
            self.process_id is not None,
            self.num_processes is not None,
        ]
        if any(explicit) and not all(explicit):
            missing = [name for name, have in
                       zip(("coordinator_address", "process_id", "num_processes"), explicit)
                       if not have]
            raise ValueError(
                f"parallel.distributed: {', '.join(missing)} unset while "
                f"other rendezvous fields are explicit — set them in the "
                f"config block or via RT1_COORDINATOR / RT1_PROCESS_ID / "
                f"RT1_NUM_PROCESSES (all three, or launch under python -m "
                f"torch.distributed.run, whose MASTER_ADDR:MASTER_PORT / RANK / "
                f"WORLD_SIZE fill them)")
        if not any(explicit):
            raise ValueError(
                "parallel.distributed.enabled with no rendezvous: set "
                "coordinator_address, process_id and num_processes (or "
                "RT1_COORDINATOR / RT1_PROCESS_ID / RT1_NUM_PROCESSES), or launch "
                "under python -m torch.distributed.run (there is no TPU "
                "metadata server to ask)")
        if self.num_processes is not None and self.num_processes < 1:
            raise ValueError(
                f"parallel.distributed.num_processes={self.num_processes} must be >= 1")
        if (self.process_id is not None and self.num_processes is not None
                and not 0 <= self.process_id < self.num_processes):
            raise ValueError(
                f"parallel.distributed.process_id={self.process_id} out of "
                f"range [0, {self.num_processes})")

    @property
    def init_method(self) -> str:
        """`env://` under the launcher (its agent's store), else the
        coordinator as a URL (`tcp://host:port` for a bare "host:port")."""
        if self.from_launcher:
            return "env://"
        addr = self.coordinator_address or ""
        return addr if "://" in addr else f"tcp://{addr}"


def _env_str(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def _env_int(*names: str) -> Optional[int]:
    v = _env_str(*names)
    return int(v) if v is not None else None


def _launcher_address() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def _int_or_none(v: Any) -> Optional[int]:
    """Config ints where -1 / None mean "defer to the environment"."""
    if v is None:
        return None
    v = int(v)
    return None if v < 0 else v


def _is_loopback(address: str) -> bool:
    host = address.split("://", 1)[-1].rsplit(":", 1)[0].strip("[]")
    return address.startswith("file://") or host in ("localhost", "127.0.0.1", "::1") \
        or host.startswith("127.")


def local_rank(opts: DistributedOptions) -> int:
    """This rank's index among the ranks of its host: the launcher's
    LOCAL_RANK, else the global rank when every rank is local (a loopback
    or file coordinator), else 0."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    if opts.coordinator_address and _is_loopback(opts.coordinator_address):
        return int(opts.process_id or 0)
    return 0


def local_world_size(opts: DistributedOptions) -> int:
    """Ranks on this host: the launcher's LOCAL_WORLD_SIZE, else the world
    when the coordinator is local, else unknown (1)."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if opts.coordinator_address and _is_loopback(opts.coordinator_address):
        return int(opts.num_processes or 1)
    return 1


def check_backend(device_type: str, opts: DistributedOptions) -> str:
    """The backend for `device_type` ("nccl" for cuda, "gloo" for cpu),
    after the checks that must hold before the rendezvous."""
    import torch
    import torch.distributed as dist

    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("parallel.distributed: a CUDA device needs the NCCL backend, "
                               "which this torch does not have (gloo is not used for CUDA)")
        count = torch.cuda.device_count()
        ranks_here, mine = local_world_size(opts), local_rank(opts)
        if ranks_here > count or mine >= count:
            raise ValueError(
                f"parallel.distributed: {ranks_here} ranks on this host (local rank {mine}) "
                f"but it has {count} GPU(s); NCCL needs one device a rank — run fewer ranks "
                f"a host, or --device cpu for gloo")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"parallel.distributed: no backend for device type {device_type!r}")


def initialize_from_config(config: Any, device=None) -> bool:
    """`torch.distributed.init_process_group` per
    `config.parallel.distributed`, for `device` (a CUDA device becomes
    `cuda:LOCAL_RANK`, NCCL; the CPU, gloo). Returns True when this call
    initialized the world; False when the block is off or the world is
    already up (idempotent: a second run in one process goes on)."""
    import torch
    import torch.distributed as dist

    opts = DistributedOptions.from_config(config)
    if not opts.enabled:
        return False
    opts.validate()
    if dist.is_initialized():
        _log.warning("parallel.distributed: already initialized in this process — "
                     "skipping re-initialization")
        return False
    dev = torch.device(device if device is not None else "cuda")
    backend = check_backend(dev.type, opts)
    kwargs = {}
    if backend == "nccl":
        index = local_rank(opts)
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend=backend, init_method=opts.init_method,
                            rank=opts.process_id, world_size=opts.num_processes,
                            timeout=datetime.timedelta(minutes=10), **kwargs)
    _log.info("parallel.distributed: rank %d/%d up (%s, coordinator %s)", dist.get_rank(),
              dist.get_world_size(), backend, opts.coordinator_address)
    return True


def rank_device(device=None):
    """The device of this rank: `cuda:LOCAL_RANK` for a CUDA device in an
    initialized NCCL world, else `device` as given."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dist.is_initialized() and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shutdown() -> None:
    """Destroy the process group, if one is up."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def free_local_port() -> int:
    """An OS-assigned free loopback port (a rendezvous port before any
    rank exists)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def world_size() -> int:
    """Ranks of the initialized world (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that owns single-writer side effects (metrics,
    manifests, markers): rank 0, or the process of a one-process run."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
