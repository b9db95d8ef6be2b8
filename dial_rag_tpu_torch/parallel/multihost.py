"""Multi-process set-up (counterpart of ``dial_rag_tpu/parallel/multihost.py``).

The reference is a single-process service. Past one host the port runs
one process a host (or a card group), joined by ``torch.distributed``:
``initialize_multihost`` starts the process group (``nccl`` between
cards, ``gloo`` on the CPU), ``create_global_mesh`` builds this process's
part of the global mesh, and the sharded indexes cross processes through
one function, ``gather_ranks``: every process holds only its own shards,
each query runs on every process (the same program on every host, as in
the JAX package), and the shards' winners, with their global row ids, are
all-gathered before the one stable merge (``sharded_index.merge_winners``).

Typical bring-up (the same program on every host):

    from dial_rag_tpu_torch.parallel.multihost import create_global_mesh, initialize_multihost
    initialize_multihost("10.0.0.1:29500", num_processes=2, process_id=rank)
    mesh = create_global_mesh(tp=1)   # dp spans every process's cards

Nothing on a machine tells a program of its cluster: the address, the
process count and this process's rank come from the arguments, else from
``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (the names
``torchrun`` sets). Every collective is bounded by the group's timeout.
"""

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from dial_rag_tpu_torch.parallel.mesh import Mesh, _grid, visible_devices

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 120.0


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Starts the process group; True if more than one process joined it.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of
    process 0. A single process (no address, or one process) gets a no-op
    False, as the JAX package's single-process callers do. ``device``
    picks the backend: ``nccl`` for CUDA, ``gloo`` for the CPU."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None or num_processes <= 1:
        logger.info("single-process mode (no coordinator address and process count)")
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    logger.info(f"multi-process: process {process_id}/{num_processes} ({backend})")
    return True


def process_layout() -> tuple[int, int]:
    """(this process's rank, the process count); (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def create_global_mesh(tp: int = 1, devices=None) -> Mesh:
    """(dp, tp) mesh over this process's ``devices`` (default: its visible
    cards), placed rank-major among the processes: with tp at most the
    devices a process holds, the tp axis stays inside a process and dp
    crosses processes only at its outer boundary."""
    devices = visible_devices("cuda") if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise RuntimeError("no CUDA device is visible; pass devices= to build a mesh on the CPU")
    rank, world = process_layout()
    if len(devices) % tp != 0:
        raise ValueError(f"{len(devices) * world} devices ({len(devices)} a process) not divisible by tp={tp}")
    return Mesh(_grid(devices, len(devices) // tp, tp), process_index=rank, process_count=world)


def gather_ranks(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every process's ``t`` (the same shape on each) concatenated along
    ``dim`` in rank order; ``t`` itself in a single process."""
    if mesh.process_count == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.process_count)]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=dim)
