"""Cooperative block-cyclic Cholesky factor over torch.distributed
(counterpart of interiorpoint_tpu/parallel/chol.py).

The row-sharded solves factor the replicated H (n × n) and Schur matrix
on every rank; ``dist_cholesky`` splits the factor's trailing update over
the ranks instead, as the JAX package's ``shard_map`` factor does:

* block-columns are owned cyclically, rank p owning block j when
  ``j % ndev == p``, so the shrinking trailing matrix stays balanced;
* at step j the owner's panel goes out by one masked all-reduce (every
  other rank contributes zeros), every rank factors the bs × bs diagonal
  block and solves the panel against it;
* the trailing update runs only on the owned block-columns (the lazy
  full-height update of the JAX program: static shapes, the triangular
  saving traded away);
* the factor comes back by one all-gather.

It is plain torch (``torch.linalg`` on the diagonal block, ``einsum`` for
the update), in the input's type (fp64, or fp32 for the mixed factor of
``make_factor_tools``): the JAX factor reaches no Pallas kernel.  With no
process group it runs the same steps on one rank.
"""

from __future__ import annotations

import torch

from . import comm


def cholesky_or_nan(M):
    """Lower factor of M, all NaN where it is not positive definite (the
    JAX package's ``jnp.linalg.cholesky`` returns NaN there, and the
    solves then reject the step; ``torch.linalg.cholesky`` would raise)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def dist_cholesky(H, group=None, block: int = 256):
    """Lower-Cholesky factor of the replicated SPD ``H``, computed by
    every rank of ``group`` together; returns the replicated (n, n) L
    with H = L·Lᵀ.  ``block`` is the panel width."""
    ndev = comm.world_size(group)
    p = comm.axis_index(group)
    n = H.shape[0]
    dtype, dev = H.dtype, H.device
    bs = min(block, n)
    nb = -(-n // bs)                 # block-columns in the true matrix
    nbl = -(-nb // ndev)             # owned block-columns per rank
    nbp = nbl * ndev                 # padded block count (cyclic-even)
    npad = nbp * bs

    # pad to npad with an identity diagonal: the padding factors to the
    # identity and is sliced away at the end
    Hp = torch.zeros((npad, npad), dtype=dtype, device=dev)
    Hp[:n, :n] = H
    pad = torch.arange(n, npad, device=dev)
    Hp[pad, pad] = 1.0

    mine = p + ndev * torch.arange(nbl, device=dev)
    # owned block-columns, stacked: (nbl, npad, bs)
    Hl = Hp.reshape(npad, nbp, bs).permute(1, 0, 2)[mine].contiguous()
    del Hp
    rows = torch.arange(npad, device=dev)

    for j in range(nbp):
        owner, jl = j % ndev, j // ndev
        cand = Hl[jl] if p == owner else torch.zeros_like(Hl[0])
        panel = comm.psum(cand, group)
        Ljj = cholesky_or_nan(panel[j * bs:(j + 1) * bs])
        # X = panel·Ljj⁻ᵀ over all rows; rows above the diagonal block
        # are masked to zero and the diagonal block is Ljj itself
        X = torch.linalg.solve_triangular(Ljj, panel.T, upper=False).T
        pcol = torch.where((rows >= (j + 1) * bs)[:, None], X,
                           torch.zeros_like(X))
        pcol[j * bs:(j + 1) * bs] = Ljj
        if p == owner:
            Hl[jl] = pcol
        # trailing update of the owned columns right of j
        U = pcol.reshape(nbp, bs, bs)[mine]
        upd = torch.einsum("rc,ibc->irb", pcol, U)
        Hl = Hl - torch.where((mine > j)[:, None, None], upd,
                              torch.zeros_like(upd))

    # reassemble: gathered (ndev, nbl, npad, bs) → block j = i·ndev + p
    allc = comm.all_gather0(Hl, group).reshape(ndev, nbl, npad, bs)
    allc = allc.transpose(0, 1).reshape(nbp, npad, bs)
    Lfull = allc.permute(1, 0, 2).reshape(npad, npad)
    return torch.tril(Lfull[:n, :n])
