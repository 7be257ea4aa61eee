"""Device meshes and multi-process bring-up.

Counterpart of `gme_tpu/parallel/mesh.py`.  A mesh is a (data, space) grid
of device slots:

- "data": independent frame pairs (data parallelism);
- "space": row bands of one frame, with halo exchange between neighbouring
  bands (`parallel/spatial.py`).

Where the JAX package lays a `jax.sharding.Mesh` over its devices and runs
one SPMD program on them, the port runs the program in one process, in
lockstep over the slots, and moves rows between slots with `Tensor.to`.  A
slot list may name one device more than once: that is how a mesh runs on
one card (or on the CPU), the counterpart of the JAX tests' eight virtual
XLA devices.  Slots are never folded silently: a mesh needs data * space
slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclass(frozen=True)
class Mesh:
    """`devices[d][s]` is the slot of data shard d, row band s."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.devices), SPACE_AXIS: len(self.devices[0])}


def default_devices() -> list:
    """The visible cards, the default slots of a mesh."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    data: Optional[int] = None,
    space: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (data, space) mesh over the slots `devices` (default: the visible
    cards), row-major.  `data=None` takes every slot the space axis leaves;
    too few slots raise."""
    devices = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    n = len(devices)
    if data is None:
        if n % space:
            raise ValueError(f"{n} devices not divisible by space={space}")
        data = n // space
    if data * space > n:
        raise ValueError(f"mesh {data}x{space} needs {data * space} devices, have {n}")
    return Mesh(tuple(tuple(devices[d * space:(d + 1) * space]) for d in range(data)))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group of a multi-process run: gloo over TCP at
    `coordinator_address` ("host:port", served by rank 0).  The run's only
    collective is its completion barrier (`parallel/multihost.py`), which
    gloo serves on the CPU and beside a card alike.  No-op for one
    process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
