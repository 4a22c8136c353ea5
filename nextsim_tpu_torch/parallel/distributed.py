"""Ranks of a multi-device run (the counterpart of
nextsim_tpu/parallel/distributed.py).

The reference boots through MPI (reference: core/src/environment.cpp:23-60)
and runs one rank per partition of the mesh (model/run.sh:55: ``mpirun -np
N``). The JAX package has one process drive all its devices. PyTorch's idiom
is one process per device, so the port runs one ``torch.distributed`` rank
per block of ``tpu.mesh_shape`` (parallel/seam.py): ``torchrun
--nproc-per-node N -m nextsim_tpu_torch ...``, or the JAX package's
variables, as tests/test_multiprocess.py sets them.

``init_distributed`` joins the process group the environment names:

* torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT``;
* else ``JAX_COORDINATOR_ADDRESS`` (host:port), ``JAX_NUM_PROCESSES`` and
  ``JAX_PROCESS_ID``, all ranks on one host.

With none of them set it returns False and the run is one process. With one
set it joins or raises: it never runs on as a single process.

The backend is ``nccl`` when every rank of the host has a card of its own,
``gloo`` otherwise: on the CPU, and when ranks share a card. Gloo's
point-to-point calls take host tensors, so parallel/halo.py stages the
strips of a card through pinned host buffers; all compute stays on the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class World:
    """A process group as the environment names it."""

    address: str  # host:port of the rank-0 store
    size: int
    rank: int
    local_rank: int
    local_size: int


def world_from_env(env=None) -> Optional[World]:
    """The world torchrun or the JAX variables name, or None."""
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        return World(
            address=f"{env.get('MASTER_ADDR', 'localhost')}:{env.get('MASTER_PORT', '29500')}",
            size=size, rank=rank,
            local_rank=int(env.get("LOCAL_RANK", rank)),
            local_size=int(env.get("LOCAL_WORLD_SIZE", size)),
        )
    address = env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
    if address:
        if not (env.get("JAX_NUM_PROCESSES") and env.get("JAX_PROCESS_ID")):
            raise ValueError(
                f"the coordinator {address} is named, but JAX_NUM_PROCESSES and "
                "JAX_PROCESS_ID are not both set"
            )
        size, rank = int(env["JAX_NUM_PROCESSES"]), int(env["JAX_PROCESS_ID"])
        return World(address=address, size=size, rank=rank, local_rank=rank, local_size=size)
    return None


def backend_for(device, local_size: int) -> str:
    """``nccl`` when every one of the host's ``local_size`` ranks has a card
    of its own, else ``gloo``."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= local_size:
        return "nccl"
    return "gloo"


def init_distributed(device="cuda", timeout: Optional[float] = None) -> bool:
    """Join the process group the environment names (module docstring).
    Returns False when it names none; raises when joining fails. ``device``
    is the run's device type (``--device``); ``timeout`` in seconds bounds
    every collective call (torch's default when None)."""
    if dist.is_initialized():
        return True
    world = world_from_env()
    if world is None:
        return False
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(
        backend_for(device, world.local_size), init_method=f"tcp://{world.address}",
        world_size=world.size, rank=world.rank, **kw,
    )
    return True


def local_device(device="cuda") -> torch.device:
    """The rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    device without an index in a process group, else ``device``. A CUDA
    device of a rank becomes its current device, which NCCL's
    point-to-point calls need."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not dist.is_initialized():
        return device
    world = world_from_env()
    local_rank = world.local_rank if world is not None else dist.get_rank()
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("a CUDA device was asked for, and none is visible")
    device = torch.device("cuda", local_rank % count)
    torch.cuda.set_device(device)
    return device


def free_port() -> int:
    """A TCP port of localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, size, port, device, timeout, args):
    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(size), "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(size), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
    })
    init_distributed(device, timeout=timeout)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_world(fn, size: int, args=(), *, device, timeout: float = 300.0) -> None:
    """Run ``fn(*args)`` on ``size`` ranks of a new process group, one
    spawned process each (``fn`` must be importable by name), all on this
    host; ``device`` (the ranks' device type) picks the backend as
    ``init_distributed`` does. Raises
    the first rank's error, or TimeoutError after ``timeout`` seconds, when
    every rank is ended; collective calls time out after ``timeout`` too."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main, args=(fn, size, free_port(), str(device), timeout, args),
        nprocs=size, join=False, start_method="spawn",
    )
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while not ctx.join(timeout=1.0):
            if datetime.datetime.now() > deadline:
                raise TimeoutError(f"a world of {size} ranks did not end within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
