"""The collectives of the row- and cone-sharded solves, one for one with
the JAX package's ``shard_map`` collectives:

    lax.psum(u, axis)                              psum(u)
    lax.pmax(u, axis)                              pmax(u)
    -lax.pmax(-u, axis), lax.pmin(u, axis)         pmin(u)
    lax.all_gather(u, axis, axis=0, tiled=True)    all_gather0(u)
    lax.all_gather(u, axis, axis=1, tiled=True)    all_gather1(u)
    lax.axis_index(axis)                           axis_index()
    the axis size                                  world_size()

Each runs over the default ``torch.distributed`` group (NCCL on the card,
gloo on the CPU; ``group=`` picks another).  With no process group the
mesh has one position: every collective is the identity and
``axis_index()`` is 0, as on a one-device JAX mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

def active() -> bool:
    """Whether a process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if active() else 1


def axis_index(group=None) -> int:
    return dist.get_rank(group) if active() else 0


def _reduce(u, op, group):
    if not active():
        return u
    out = u.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(u, group=None):
    return _reduce(u, dist.ReduceOp.SUM, group)


def pmax(u, group=None):
    return _reduce(u, dist.ReduceOp.MAX, group)


def pmin(u, group=None):
    return _reduce(u, dist.ReduceOp.MIN, group)


def all_gather0(u, group=None):
    """Every rank's ``u`` stacked along dimension 0, in rank order."""
    if not active():
        return u
    u = u.contiguous()
    ws = dist.get_world_size(group)
    out = torch.empty((ws * u.shape[0],) + tuple(u.shape[1:]),
                      dtype=u.dtype, device=u.device)
    dist.all_gather_into_tensor(out, u, group=group)
    return out


def all_gather1(u, group=None):
    """Every rank's (r, c) ``u`` joined along dimension 1, in rank order."""
    if not active():
        return u
    return all_gather0(u.T, group).T


def barrier(group=None) -> None:
    if active():
        dist.barrier(group=group)
