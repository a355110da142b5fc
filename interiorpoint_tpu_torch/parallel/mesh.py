"""Device meshes of the port (counterpart of
interiorpoint_tpu/parallel/mesh.py).

A ``Mesh`` is a numpy array of ``torch.device``s with named axes; as with
the JAX mesh, ``mesh.shape[axis]`` is the number of positions along an
axis.  ``make_mesh`` builds one of two forms:

* with ``torch.distributed`` initialized, one position per rank of the
  default group: ``cuda:{local rank}`` under NCCL, the CPU under gloo.
  This is the counterpart of the JAX mesh over every process's devices
  after ``initialize``; the row- and cone-sharded solves run one rank
  per position.
* without it, this process's devices: the cards (``device=None``, which
  raises when there is none, as ``default_device()`` does), or
  ``n_devices`` CPU entries with ``device="cpu"``, the counterpart of the
  JAX tests' virtual CPU mesh.  ``solve_batch`` places its shards on
  these devices; ``solve_lasso_sharded`` solves on the first.

``batch_sharding`` and ``replicated`` return a ``Placement``: which
dimension is split, over which axis of which mesh.  ``Placement.shards``
splits a length into the contiguous per-position ranges XLA's tiling
gives a sharded dimension (⌈B/p⌉ per position, the last ones short or
empty).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.base import default_device


class Mesh:
    """Devices on named axes; ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("one axis name per mesh dimension")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def position_device(self, axis: str, index: int) -> torch.device:
        """The device of position ``index`` along ``axis`` (the first one
        along the other axes)."""
        sel = [0] * self.devices.ndim
        sel[self.axis_names.index(axis)] = index
        return self.devices[tuple(sel)]

    def __repr__(self):
        return f"Mesh({self.shape}, {self.devices.flat[0]}...)"


def _rank_device(rank: int, backend: str) -> torch.device:
    if backend != "nccl":
        return torch.device("cpu")
    count = max(torch.cuda.device_count(), 1)
    if rank == dist.get_rank() and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", rank % count)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("batch",),
              shape: Optional[Sequence[int]] = None, *,
              device=None) -> Mesh:
    """A mesh over the first ``n_devices`` devices (see the module
    docstring for which devices).  One axis name makes a 1-D mesh; pass
    ``shape`` for more (e.g. shape=(2, 4), axis_names=("batch", "rows"))."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(
                f"a mesh under torch.distributed spans the {world} ranks "
                f"of the default group, not {n_devices}")
        backend = dist.get_backend()
        devs = [_rank_device(r, backend) for r in range(world)]
    else:
        dev = torch.device(device) if device is not None \
            else default_device()
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            devs = [torch.device("cuda", i) for i in range(count)]
        else:
            devs = [dev] * (1 if n_devices is None else int(n_devices))
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"{n_devices} devices asked for, "
                                 f"{len(devs)} present")
            devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), axis_names)


class Placement(NamedTuple):
    """Where an array lives on a mesh: ``dim`` split over ``axis`` (None:
    replicated on every position)."""

    mesh: Mesh
    axis: Optional[str]
    ndim: int
    dim: Optional[int]

    def shards(self, size: int):
        """[(device, start, stop)] of the non-empty contiguous shards of a
        dimension of length ``size`` (one whole shard when replicated)."""
        if self.axis is None:
            return [(self.mesh.devices.flat[0], 0, size)]
        p = self.mesh.shape[self.axis]
        chunk = -(-size // p)
        out = []
        for i in range(p):
            lo, hi = i * chunk, min((i + 1) * chunk, size)
            if hi > lo:
                out.append((self.mesh.position_device(self.axis, i), lo,
                            hi))
        return out


def batch_sharding(mesh: Mesh, axis: str = "batch", ndim: int = 1,
                   batch_dim: int = 0) -> Placement:
    """``batch_dim`` of an ndim-array split over ``axis``."""
    return Placement(mesh, axis, ndim, batch_dim)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None, 0, None)
