"""Process groups of a multi-GPU run: the counterpart of ``segan_pytorch_tpu/parallel/
mesh.py``.

The JAX package drives every chip of a host from one process and lays them out as a
('data', 'model') mesh. The port runs one process per card, ``cuda:{local rank}``, so
``--dp N`` on one host is N processes (``train.py`` spawns them) and a multi-host run
is one process per card on every host. ``make_grid(dp, mp)`` is ``make_mesh``: rank
d * mp + m holds data shard d and model shard m, the model axis innermost; every rank
is in one data group (the ranks of its model index, over which batch statistics, loss
counts and gradients are summed) and one model group (the ranks of its data index,
over which D's head is split).

``initialize_distributed`` joins the group through ``torch.distributed`` with a finite
timeout, so a lost peer fails the run instead of hanging it: NCCL on the card, gloo for
``--device cpu`` (or when asked, as ``chip_smoke.py`` asks for two processes sharing one
card). Host-side exchanges (barriers, the evaluation's scores, the resume checksum) go
over a gloo group of every process, ``host_group()``.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0

# the group's timeout and the gloo group of every process, once made (one per process)
_STATE = {}


def init_method(coordinator: str) -> str:
    """--coordinator as torch's init method: 'host:port' -> 'tcp://host:port'; a URL
    (tcp://, file://) as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def require_device(device) -> torch.device:
    """`device` as a torch device; CUDA without a card raises rather than run on the CPU
    unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: pass --device cpu to run on the CPU")
    return device


def local_device(device, process_id: int) -> torch.device:
    """The device that process `process_id` drives: ``cuda:{process_id % cards}`` on the
    card (one process per card), the CPU for cpu."""
    device = require_device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", process_id % torch.cuda.device_count())


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the run's process group (the JAX ``initialize_distributed``, ``:23``) and
    return the device this process drives.

    Nothing is joined for one process without a coordinator; a coordinator given with
    ``num_processes`` 1 makes a group of one, which runs the grouped code on one card.
    The backend is NCCL for CUDA and gloo for the CPU unless `backend` says otherwise;
    every collective of the group fails after `timeout_s`."""
    process_id = 0 if process_id is None else int(process_id)
    if num_processes is None or (num_processes <= 1 and coordinator is None):
        return require_device(device)
    if coordinator is None:
        raise ValueError(f"--num_processes {num_processes} needs --coordinator "
                         "(host:port of process 0, or an init URL such as file:///path)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} out of range [0, {num_processes})")
    dev = local_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method(coordinator),
                            world_size=int(num_processes), rank=process_id,
                            timeout=timeout)
    _STATE["timeout"] = timeout
    host_group()
    return dev


def _run_rank(process_id: int, fn, coordinator: str, nprocs: int, args: tuple):
    _STATE["spawned"] = True  # one launcher: see launcher_count
    fn(coordinator, nprocs, process_id, *args)


def spawn_local(fn, nprocs: int, device="cuda", args: tuple = ()):
    """Run ``fn(coordinator, nprocs, process_id, *args)`` in `nprocs` spawned processes
    of this host, one per card, which join one group through a file in a new temporary
    directory (no port to pick). On the card the kernels are built first, so that no
    two processes build them at once, and `nprocs` may not exceed the cards. Raises
    when any process fails; the others are then stopped."""
    import torch.multiprocessing

    if require_device(device).type == "cuda":
        from ..ops.kernels import build

        cards = torch.cuda.device_count()
        if nprocs > cards:
            raise ValueError(f"{nprocs} processes need {nprocs} devices, have {cards}: "
                             "one process drives one card")
        for name in ("conv1d_prelu", "encoder_fused"):
            build.build_library(name)
    with tempfile.TemporaryDirectory() as tmp:
        coordinator = "file://" + os.path.join(tmp, "rendezvous")
        torch.multiprocessing.start_processes(
            _run_rank, args=(fn, coordinator, nprocs, tuple(args)), nprocs=nprocs,
            start_method="spawn")


def _timeout() -> datetime.timedelta:
    """The timeout of the groups this module makes: the one the group was joined with."""
    return _STATE.get("timeout", datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))


def host_group():
    """The gloo group of every process, for exchanges of host data: the default group
    when it is gloo, else one made the first time (every process must ask in the same
    order, as ``initialize_distributed`` does right after joining)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if "host" not in _STATE:
        _STATE["host"] = dist.new_group(backend="gloo", timeout=_timeout())
    return _STATE["host"]


def launcher_count() -> int:
    """The processes of the group that were started apart: the counterpart of
    ``jax.process_count()``. One JAX process drives every chip of its host, and so does
    the group that ``spawn_local`` starts on one host (``train --dp N [--mp M]`` alone):
    it counts 1. So does a group of one. A group joined with ``--num_processes`` P, one
    launch per process, counts P. Every process of a group reads the same count."""
    return 1 if _STATE.get("spawned") else process_count()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def distributed_barrier(name: str, timeout_s: float = 240.0):
    """Wait until every process is here (no-op for one process): a monitored gloo
    barrier, which names the processes that did not arrive within `timeout_s`."""
    if process_count() <= 1:
        return
    dist.monitored_barrier(group=host_group(),
                           timeout=datetime.timedelta(seconds=timeout_s))


def shutdown_distributed():
    """Leave the process group, every process together (no-op without one)."""
    if not dist.is_initialized():
        return
    distributed_barrier("shutdown")
    _STATE.clear()
    dist.destroy_process_group()


@dataclass(frozen=True)
class Grid:
    """This process's place in a dp x mp grid, with its data group (same model index,
    every data index) and its model group (same data index, every model index). The
    groups are None when no process group was joined."""

    dp: int
    mp: int
    dp_index: int
    mp_index: int
    dp_group: object = None
    mp_group: object = None

    @property
    def rank(self) -> int:
        return self.dp_index * self.mp + self.mp_index

    def rows(self, local_batch: int) -> slice:
        """The rows of the global batch that this process's data shard holds."""
        return slice(self.dp_index * local_batch, (self.dp_index + 1) * local_batch)


def make_grid(dp: Optional[int] = None, mp: int = 1,
              axis_names: Sequence[str] = ("data",), world: Optional[int] = None) -> Grid:
    """The dp x mp grid of the processes (the JAX ``make_mesh``, ``:76-108``): its
    checks, with the process count in place of the device count, and its defaults (dp
    from the count over mp). Every process of the group is in the grid: a dp * mp below
    the count raises too, since each process drives a card of its own. When a group was
    joined, every process makes the data and model groups, in the same order."""
    world = process_count() if world is None else int(world)
    if not isinstance(mp, (int, np.integer, type(None))):
        raise TypeError(f"mp must be an int, got {type(mp).__name__} "
                        "(pass axis_names by keyword)")
    mp = int(mp or 1)
    if mp > 1:
        if tuple(axis_names) not in (("data",), ("data", "model")):
            raise ValueError("axis_names is fixed to ('data', 'model') when mp > 1")
        if dp is None or dp <= 0:
            if world % mp != 0:
                raise ValueError(f"device count {world} not divisible by mp={mp}")
            dp = world // mp
        need = dp * mp
        if need > world:
            raise ValueError(f"dp*mp={need} exceeds available devices {world}")
    else:
        if dp is None or dp <= 0:
            dp = world
        if dp > world:
            raise ValueError(f"dp={dp} exceeds available devices {world}")
        need = dp
    if need != world:
        raise ValueError(f"dp*mp={need} leaves {world - need} of the {world} processes "
                         "out of the grid: the port runs one process per card")
    rank = process_index()
    dp_group = mp_group = None
    if dist.is_initialized():
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)], timeout=_timeout())
            if m == rank % mp:
                dp_group = g
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)], timeout=_timeout())
            if d == rank // mp:
                mp_group = g
    return Grid(int(dp), mp, rank // mp, rank % mp, dp_group, mp_group)
