"""Runtime bootstrap: process-group init, CPU rank simulation, topology:
the port of ``tpu_parallel/runtime/bootstrap.py``.

``jax.distributed.initialize`` becomes ``torch.distributed.
init_process_group``, one process per device: NCCL for a CUDA device, gloo
for the CPU.  JAX's ``simulate_cpu_devices(n)`` (n virtual CPU devices in
one process) becomes :func:`spawn_cpu_ranks` (n gloo CPU processes), since
a torch process drives one device.  JAX's ``enable_compilation_cache`` has
no counterpart here: the port compiles nothing at run time but its CUDA
kernels, which ``ops/build.py`` already keeps in a build directory.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from tpu_parallel_torch.runtime.device import resolve_device

logger = logging.getLogger("tpu_parallel_torch")

_SIMULATED = False
_DEVICE: Optional[torch.device] = None  # the device initialize() bound this process to


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """Bootstrap the distributed runtime.

    - A bare process (no arguments, not launched by torchrun): no-op, as in
      JAX; the port then runs on one device.
    - Launched by ``python -m torch.distributed.run`` (``WORLD_SIZE`` and
      ``RANK`` in the environment, ``MASTER_ADDR``/``MASTER_PORT`` the
      rendezvous), or given any argument: ``init_process_group``, even for a
      world of one, so a torchrun launch always has its group.
      ``coordinator_address`` is ``host:port`` (TCP) or an ``init_method``
      URL such as ``file:///tmp/rendezvous``.

    ``device`` names this process's device; a CUDA device without an index
    is ``cuda:{LOCAL_RANK}``, made current before the group starts.  The
    backend follows the device (NCCL for CUDA, gloo for the CPU) unless
    ``backend`` names one; nothing falls back to another backend.
    """
    global _DEVICE
    env = os.environ
    launched = "WORLD_SIZE" in env and "RANK" in env
    if not (launched or coordinator_address is not None or num_processes is not None
            or process_id is not None):
        logger.debug("single-process runtime; skipping init_process_group")
        return
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _DEVICE = dev


def is_simulated() -> bool:
    """True inside the ranks :func:`spawn_cpu_ranks` starts."""
    return _SIMULATED


def _rank_main(rank: int, n: int, rendezvous: str, fn, args) -> None:
    global _SIMULATED
    _SIMULATED = True
    # n ranks share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    initialize(f"file://{rendezvous}", n, rank, backend="gloo", device="cpu")
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_cpu_ranks(num_ranks: int, fn, *args) -> None:
    """Run ``fn(*args)`` in ``num_ranks`` new CPU processes joined in one
    gloo group (a ``file://`` rendezvous under a temporary directory), the
    counterpart of JAX's ``simulate_cpu_devices``: every collective, mesh
    and sharded tensor then behaves as on ``num_ranks`` devices.  Each rank
    sees :func:`is_simulated` true and runs one intra-op thread; ``fn`` and
    ``args`` must pickle (a module-level function).  Blocks until every
    rank has finished; a rank's exception is raised here."""
    import torch.multiprocessing as mp

    directory = tempfile.mkdtemp(prefix="tpu_parallel_torch_ranks_")
    try:
        mp.start_processes(_rank_main, args=(num_ranks, os.path.join(directory, "rendezvous"),
                                             fn, args),
                           nprocs=num_ranks, join=True, start_method="spawn")
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def process_info() -> dict:
    """Topology snapshot for logging: JAX's keys (process index and count,
    local and global device counts, platform ``"gpu"`` or ``"cpu"``) and
    the group's ``backend`` (None without a group).  One device per
    process."""
    up = dist.is_initialized()
    device = _DEVICE if up and _DEVICE is not None else None
    if device is None:
        gpu = torch.cuda.is_available() and not _SIMULATED
    else:
        gpu = device.type == "cuda"
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_device_count": 1,
        "global_device_count": dist.get_world_size() if up else 1,
        "platform": "gpu" if gpu else "cpu",
        "backend": dist.get_backend() if up else None,
    }
