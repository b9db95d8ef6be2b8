"""Device mesh and the dp split of a batch (counterpart of
``dial_rag_tpu/parallel/mesh.py``).

A ``Mesh`` is a ``(dp, tp)`` grid of ``torch.device``s, the counterpart of
``jax.sharding.Mesh``. The port keeps the JAX package's single-controller
shape: one process holds the mesh, launches work on each of its devices
and gathers the results on the first one.

- ``dp`` (data parallel): an encode batch's rows split into dp contiguous
  slots (``dp_slots``), each encoded on its slot's device
  (``BgeEmbedder.shard_over``);
- ``tp``: the second axis of the grid. Serving reads it only through the
  indexes, which shard their rows over every device of the mesh, tp
  included (``parallel/sharded_index.py``).

A mesh may name one device more than once. That is the port's
counterpart of the 8 host devices the JAX tests get from
``conftest.py``: the CPU tests build meshes of ``[cpu] * 8``, and
``chip_smoke.py`` one of ``[cuda:0] * 4`` where one card is visible. A
service builds its mesh over the visible cards (``visible_devices``).

Across processes (``parallel/multihost.py``) a mesh holds this process's
devices and knows its place among the processes: the global grid is the
processes' grids stacked along dp in rank order.
"""

import numpy as np
import torch


def _grid(devices, rows: int, cols: int) -> np.ndarray:
    grid = np.empty(rows * cols, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = torch.device(d)
    return grid.reshape(rows, cols)


class Mesh:
    """``devices`` [dp, tp] (this process's); ``process_index`` of
    ``process_count`` processes, each holding a grid of the same shape."""

    def __init__(self, devices: np.ndarray, process_index: int = 0, process_count: int = 1):
        self.devices = devices
        self.process_index = process_index
        self.process_count = process_count

    @property
    def shape(self) -> dict:
        """The global grid's shape by axis name."""
        dp, tp = self.devices.shape
        return {"dp": dp * self.process_count, "tp": tp}

    @property
    def size(self) -> int:
        """Devices of the global grid."""
        return self.devices.size * self.process_count

    @property
    def local_devices(self) -> list:
        """This process's devices in grid order (row-major)."""
        return list(self.devices.reshape(-1))

    @property
    def first_device(self) -> torch.device:
        """Where queries arrive and results are gathered."""
        return self.devices.flat[0]

    @property
    def shard_offset(self) -> int:
        """The global index of this process's first device: processes are
        rank-major, so process r holds devices [r * n, (r + 1) * n)."""
        return self.process_index * self.devices.size

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices={[str(d) for d in self.local_devices]}, "
                f"process {self.process_index} of {self.process_count})")


def visible_devices(device: str | torch.device = "cuda") -> list:
    """Every visible card when ``device`` is a CUDA device, else ``[device]``."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def create_mesh(n_devices: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """(dp, tp) mesh over the first ``n_devices`` of ``devices`` (default:
    every visible card; raises when there is none)."""
    devices = visible_devices("cuda") if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise RuntimeError("no CUDA device is visible; pass devices= to build a mesh on the CPU")
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
    if n_devices % tp != 0:
        raise ValueError(f"{n_devices} devices not divisible by tp={tp}")
    return Mesh(_grid(devices[:n_devices], n_devices // tp, tp))


def dp_slots(mesh: Mesh, rows: int) -> list[tuple[torch.device, slice]]:
    """(device, rows) of each dp slot of a leading batch dimension of
    ``rows``, a multiple of dp: dp contiguous slots, one on each grid row's
    first device (the JAX package's ``batch_sharding``: split over dp,
    replicated over tp)."""
    devs = list(mesh.devices[:, 0])
    if rows % len(devs):
        raise ValueError(f"{rows} rows do not split into {len(devs)} dp slots")
    per = rows // len(devs)
    return [(d, slice(i * per, (i + 1) * per)) for i, d in enumerate(devs)]
