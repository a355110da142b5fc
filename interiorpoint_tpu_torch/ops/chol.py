"""Blocked Cholesky factor and solve (K3) and the factor pieces (factor,
inverse W = L⁻¹, W-solve, in fp32 and fp64) that the step kernels share
with it.

Counterpart of interiorpoint_tpu/ops/pallas_chol.py:

* ``cholesky_blocked(H, jitter)`` (K3a) -> ``(L, Dinv, bad)``: the lower
  factor of H + jitter·I, the inverted b x b diagonal blocks of the
  identity-padded factor, and a device flag (int32, 0-dim) that is 1 when
  a pivot was not positive (L then holds NaN, as jnp.linalg.cholesky's
  would).  Replaces ``_chol_kernel`` (pallas_chol.py:143).
* ``cholesky_solve_blocked(L, Dinv, B)`` (K3b): X with (L Lᵀ) X = B, both
  triangles in one kernel.  Replaces ``_solve_kernel`` (pallas_chol.py:172).

The CUDA sources are ``csrc/chol.cu`` and, for the solve,
``csrc/csolve.cu`` at p = 1 and ``csrc/wsolve.cu`` at p > 1
(``solve_route``).  Each wrapper launches the kernel
for CUDA tensors and calls its ``*_plain`` twin for CPU tensors; any other
device raises.  ``Dinv`` is (n_pad, b) for the block edge b of the
backend: the CUDA kernel's edge is read from the library (``cuda_block``;
64, where the TPU kernel used its 128-wide matrix unit's tile), and the
plain versions use their own ``PLAIN_BLK``.  The identity padding leaves the
factor of the leading n x n block unchanged, so the two need not agree.

The plain versions are straightforward PyTorch in the source's type with
the same outputs: ``torch.linalg.cholesky_ex`` for the factor, triangular
solves for the block inverses.  K3a and K3b themselves are fp32; the
pieces take fp32 (K1, K2, K4) or fp64 (K5's factors).
"""

from __future__ import annotations

import torch

from ..kernels import _build

PLAIN_BLK = 64


def cuda_block() -> int:
    """Block edge of the CUDA factor (csrc/chol.cu)."""
    return _build.query("ip_chol_block")


def padded(n: int, blk: int) -> int:
    """n rounded up to a whole number (at least one) of blk-blocks."""
    return max(blk, -(-n // blk) * blk)


def _need(t: torch.Tensor, dtype, ndim: int, name: str):
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# Shared factor pieces (used by K3a below, by ops/pd_step.py's backends in
# fp32 and by K5's in fp64).  Each takes and returns padded (np x np)
# matrices of the source's type; the CUDA entry of each type has the
# suffix in ``_ENTRY``.
# ---------------------------------------------------------------------------

_ENTRY = {torch.float32: "", torch.float64: "64"}


def _entry(name: str, dtype) -> str:
    if dtype not in _ENTRY:
        raise ValueError(f"{name}: expected float32 or float64, got {dtype}")
    return name + _ENTRY[dtype]


def flag_words(table: dict, device, words: int):
    """(flag words, call number) for the next launch on ``device`` of a
    kernel that orders its blocks through int64 flag words counted from
    (call << 16): ``table`` keeps one zeroed buffer per device, zeroed
    again only when a launch needs more words or the call number would
    leave a C int (the launches of one device run in stream order, as
    every caller here makes them)."""
    ent = table.get(device)
    if ent is None or ent[0].numel() < words or ent[1] >= 2 ** 31 - 1:
        ent = table[device] = [
            torch.zeros(words, dtype=torch.int64, device=device), 0]
    ent[1] += 1
    return ent[0], ent[1]


# ip_chol_factor's flag words per device and the calls made on them
_FACTOR_FLAGS = {}


def factor_cuda(src: torch.Tensor, n: int, np_: int, delta: float,
                out=None, after=None, bad=None):
    """Factor tril(src[:n,:n]) + delta·I, identity-padded to np x np:
    returns (L, Dinv, bad) on the GPU in src's type (fp32 or fp64), one
    cooperative launch.  ``src`` may be a row-major view with a longer row
    stride.  ``out`` = (L, Dinv) of an earlier call receives the factor;
    with ``after`` (the previous rung's ``bad``, a 0-dim int32 device
    flag) nothing runs unless it is set: ``out`` then keeps what it held
    and this call's ``bad`` stays 0, so the rungs after it skip too.
    ``bad`` (a zeroed 0-dim int32 device tensor) receives the flag.  The
    kernel orders its tiles through flag words of this device
    (``_FACTOR_FLAGS``)."""
    if src.ndim != 2 or src.stride(1) != 1 or src.stride(0) < n \
            or min(src.shape) < n:
        raise ValueError("factor: src must be a matrix with unit column "
                         f"stride holding {n} x {n}")
    if not 0 <= n <= np_:
        raise ValueError(f"factor: n = {n} must lie in [0, np = {np_}]")
    entry = _entry("ip_chol_factor", src.dtype)
    for flag in (after, bad):
        if flag is not None and (flag.dtype != torch.int32
                                 or flag.numel() != 1
                                 or flag.device != src.device):
            raise ValueError("factor: after and bad must be one int32 on "
                             "src's device")
    if out is None:
        A = torch.empty((np_, np_), dtype=src.dtype, device=src.device)
        Dinv = torch.empty((np_, cuda_block()), dtype=src.dtype,
                           device=src.device)
    else:
        A, Dinv = out
        if A.shape != (np_, np_) or Dinv.shape != (np_, cuda_block()) or \
                A.dtype != src.dtype or Dinv.dtype != src.dtype:
            raise ValueError("factor: out must be an (np, np) factor and "
                             "its (np, block) Dinv of src's type")
    if bad is None:
        bad = torch.zeros((), dtype=torch.int32, device=src.device)
    flags, call = flag_words(_FACTOR_FLAGS, src.device,
                             _build.query("ip_chol_flag_words", np_))
    _build.launch(entry, src, n, src.stride(0), float(delta), A, np_, Dinv,
                  bad, after, flags, call)
    return A, Dinv, bad


def factor_plain(src: torch.Tensor, n: int, np_: int, delta: float,
                 out=None, after=None, bad=None):
    """Plain twin of ``factor_cuda`` (fp32 or fp64)."""
    dt, dev = src.dtype, src.device
    if bad is None:
        bad = torch.zeros((), dtype=torch.int32, device=dev)
    if after is not None and not int(after):
        if out is None:
            out = (torch.full((np_, np_), float("nan"), dtype=dt,
                              device=dev),
                   torch.full((np_, PLAIN_BLK), float("nan"), dtype=dt,
                              device=dev))
        return out[0], out[1], bad
    A = torch.eye(np_, dtype=dt, device=dev)
    A[:n, :n] = torch.tril(src[:n, :n]) + delta * torch.eye(
        n, dtype=dt, device=dev)
    L, info = torch.linalg.cholesky_ex(A)
    if int(info) != 0:
        L = torch.full_like(A, float("nan"))
    b = PLAIN_BLK
    Dinv = torch.empty((np_, b), dtype=dt, device=dev)
    eye = torch.eye(b, dtype=dt, device=dev)
    for k0 in range(0, np_, b):
        Dinv[k0:k0 + b] = torch.linalg.solve_triangular(
            L[k0:k0 + b, k0:k0 + b], eye, upper=False)
    bad.fill_(int(not bool(torch.isfinite(Dinv).all())))
    if out is not None:
        out[0].copy_(L)
        out[1].copy_(Dinv)
        L, Dinv = out
    return L, Dinv, bad


def invert_cuda(L: torch.Tensor, Dinv: torch.Tensor,
                after=None) -> torch.Tensor:
    """W = L⁻¹ (lower, L's type) from the blocked factor: one cooperative
    launch, with an np x np scratch for its accumulators.  With ``after``
    (a 0-dim int32 device flag) nothing runs unless it is set: W is then
    not written."""
    entry = _entry("ip_chol_invert", L.dtype)
    _need(L, L.dtype, 2, "invert")
    _need(Dinv, L.dtype, 2, "invert")
    np_ = L.shape[0]
    if L.shape != (np_, np_) or np_ % cuda_block() or \
            Dinv.shape != (np_, cuda_block()) or L.device != Dinv.device:
        raise ValueError("invert: L must be a padded square factor and "
                         "Dinv its diagonal-block inverses, on one device")
    _flag("invert", after, L)
    W = torch.empty_like(L)
    _build.launch(entry, L, Dinv, W, torch.empty_like(L), np_, after)
    return W


def invert_plain(L: torch.Tensor, Dinv: torch.Tensor,
                 after=None) -> torch.Tensor:
    del Dinv
    if after is not None and not int(after):
        return torch.empty_like(L)
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def pivot_floor_cuda(L: torch.Tensor, floor2: float, bad, after=None):
    """``bad`` |= 1 when the smallest L_ii² of the fp32 factor L is at or
    below ``floor2`` (or not finite), on the device (one block); with
    ``after`` nothing runs unless it is set."""
    _need(L, torch.float32, 2, "pivot_floor")
    _flag("pivot_floor", after, L)
    _flag("pivot_floor", bad, L)
    n = L.shape[0]
    _build.launch("ip_pivot_floor", L, L.stride(0), n, float(floor2), after,
                  bad)
    return bad


def pivot_floor_plain(L: torch.Tensor, floor2: float, bad, after=None):
    if after is not None and not int(after):
        return bad
    piv2 = torch.diagonal(L).square().amin()
    if not bool(piv2 > floor2):
        bad.fill_(1)
    return bad


def _flag(name, t, like):
    if t is not None and (t.dtype != torch.int32 or t.numel() != 1
                          or t.device != like.device):
        raise ValueError(f"{name}: a flag must be one int32 on the device "
                         "of its operands")


def w_solve_cuda(W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = Wᵀ(W b) on the leading len(b) entries, i.e. (L Lᵀ)⁻¹ b, in W's
    type."""
    entry = _entry("ip_w_solve", W.dtype)
    _need(W, W.dtype, 2, "w_solve")
    _need(b, W.dtype, 1, "w_solve")
    n = b.shape[0]
    if W.shape[0] < n or W.shape[1] < n or W.device != b.device:
        raise ValueError("w_solve: W must hold len(b) x len(b), on the "
                         "device of b")
    u = torch.empty_like(b)
    x = torch.empty_like(b)
    _build.launch(entry, W, W.shape[1], n, b, u, x)
    return x


def w_solve_plain(W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    Wn = W[:n, :n]
    return Wn.T @ (Wn @ b)


# The routes of the solve on the card (``solve_route``): "column", the
# one-column kernel of csrc/csolve.cu at p = 1 up to COLUMN_MAX_N rows (one
# thread-block cluster that holds the factor's lower triangle and its
# diagonal tiles in shared memory; one stack of diagonal tiles, as K3b's
# F = G and the LDL's M are); "wide", the cluster kernel of csrc/wsolve.cu
# (column chunks that keep their block rows in shared memory) at p > 1 up
# to WIDE_MAX_N rows; "chunked", chol.cu's tasks (one column a task at
# p = 1, else 8) ordered by flags in global memory, beyond those sizes and
# for a factor whose rows the cluster kernels cannot read (not 16-byte
# aligned, ``layout_route``).  Each bound is the widest this
# module sends its kernel (the kernels refuse what does not fit): at
# COLUMN_MAX_N = 1024 both tile edges (64 for K3b, 128 for the LDL) fill
# the cluster's 16 blocks.  The wide kernel beat the chunked one at every
# width the port gives the solve (device ms, chunked against wide, on an
# NVIDIA H100 80GB HBM3 at 700 W, chip_ab.py --k3b; PERF.md): K3b
# at n = 1001, p = 2 and 3 0.218 / 0.114, p = 256 0.336 / 0.146, p = 1001
# 0.898 / 0.200; (61, 61) 0.0143 / 0.0063; the LDL reseed at np = 256
# 0.049 / 0.017, np = 1024 0.919 / 0.162.
COLUMN_MAX_N = 1024
WIDE_MAX_N = 4096


def solve_route(n: int, p: int, te: int) -> str:
    """The kernel that solves n rows and p right-hand sides with te-row
    tiles on the card: "column", "wide" or "chunked"."""
    if te not in (64, 128):
        raise ValueError(f"block_solve: no kernel has {te}-row tiles")
    if p == 1:
        return "column" if n <= COLUMN_MAX_N else "chunked"
    return "wide" if n <= WIDE_MAX_N else "chunked"


def layout_route(route: str, L: torch.Tensor, tiles) -> str:
    """``route`` where the cluster kernels can read L and the diagonal
    tiles (rows 16 bytes apart, bases 16-byte aligned), else "chunked"."""
    if route != "chunked" and (L.stride(0) % 4 or any(
            t.data_ptr() % 16 for t in [L] + list(tiles))):
        return "chunked"
    return route


# the chunked kernel's flag words per device and the calls made on them
_SOLVE_FLAGS = {}


def block_solve_cuda(L: torch.Tensor, B: torch.Tensor, fwd=None, mid=None,
                     bwd=None, blk: int = 0, after=None,
                     out=None) -> torch.Tensor:
    """The blocked two-triangle solve on the card, one launch: the forward
    sweep y_i = F_i (b_i − Σ_{j<i} L_ij y_j), u_i = M_iᵀ y_i, the
    backward sweep x_i = G_iᵀ (u_i − Σ_{j>i} L_jiᵀ x_j), over the b-row
    tiles of the leading n × n of L (n = len(B); a row-major view with
    unit column stride, only its strictly lower tiles read; rows and
    columns past n read as the identity's).  F, M, G are (np, b) stacks
    of b × b tiles (``fwd``, ``mid``, ``bwd``; None is the identity).
    K3b: F = G = Dinv; the LDL solve: M = the tile inverses.  B is (n,)
    or (n, p) fp32, contiguous; X comes out in B's shape.  The kernel is
    ``solve_route``'s, after ``layout_route``; its "column" route takes
    one stack (F, M and G each None or that stack).  With ``after`` (a
    0-dim int32 device flag; the "wide" route only) nothing runs unless it
    is set: ``out`` (or the new X) then keeps what it held."""
    n = B.shape[0]
    blk = blk or cuda_block()
    np_ = padded(n, blk)
    if L.ndim != 2 or L.dtype != torch.float32 or L.stride(1) != 1 or \
            L.stride(0) < n or min(L.shape) < n or B.ndim not in (1, 2) \
            or B.dtype != torch.float32 or not B.is_contiguous():
        raise ValueError("block_solve: L must be an fp32 matrix with unit "
                         "column stride holding len(B) x len(B), and B a "
                         "contiguous fp32 vector or matrix")
    diags = [t for t in (fwd, mid, bwd) if t is not None]
    for t in diags:
        _need(t, torch.float32, 2, "block_solve")
        if t.shape[1] != blk or t.shape[0] < np_:
            raise ValueError("block_solve: the diagonal tiles must be an "
                             f"({np_}, {blk}) stack")
    if any(t.device != B.device for t in [L] + diags):
        raise ValueError("block_solve: every tensor must be on one device")
    p = 1 if B.ndim == 1 else B.shape[1]
    route = layout_route(solve_route(n, p, blk), L, diags)
    if route == "column" and len({t.data_ptr() for t in diags}) > 1:
        raise ValueError("block_solve: the one-column kernel takes one "
                         "stack of diagonal tiles")
    if after is not None and route != "wide":
        raise ValueError("block_solve: only the wide route takes `after`")
    _flag("block_solve", after, B)
    X = torch.empty_like(B) if out is None else out
    if X.shape != B.shape or X.dtype != B.dtype or not X.is_contiguous() \
            or X.device != B.device:
        raise ValueError("block_solve: out must be shaped as B")
    if n == 0 or p == 0:
        return X
    if route == "column":
        _build.launch("ip_block_solve_column", L, L.stride(0), n, blk, fwd,
                      mid, bwd, B, X)
    elif route == "wide":
        _build.launch("ip_block_solve_wide", L, L.stride(0), n, blk, fwd,
                      mid, bwd, B, X, p, after)
    else:
        flags, call = flag_words(
            _SOLVE_FLAGS, B.device,
            _build.query("ip_block_solve_flags", n, p, blk))
        _build.launch("ip_block_solve", L, L.stride(0), n, blk, fwd, mid,
                      bwd, B, X, p, flags, call)
    return X


# ---------------------------------------------------------------------------
# K3a: standalone blocked factor
# ---------------------------------------------------------------------------

def cholesky_blocked(H: torch.Tensor, jitter: float = 0.0):
    """Lower Cholesky factor of the fp32 SPD matrix ``H + jitter·I``.

    Returns ``(L, Dinv, bad)``: L (n, n); Dinv (n_pad, block), the
    inverted diagonal blocks consumed by ``cholesky_solve_blocked``; bad,
    a 0-dim int32 flag set when the factor is not finite."""
    _need(H, torch.float32, 2, "cholesky_blocked")
    if H.shape[0] != H.shape[1]:
        raise ValueError("cholesky_blocked: H must be square")
    if _device_kind(H) == "cpu":
        return cholesky_blocked_plain(H, jitter)
    n = H.shape[0]
    A, Dinv, bad = factor_cuda(H, n, padded(n, cuda_block()), jitter)
    cholesky_blocked.launches += 1
    return A[:n, :n], Dinv, bad


def cholesky_blocked_plain(H: torch.Tensor, jitter: float = 0.0):
    cholesky_blocked_plain.calls += 1
    n = H.shape[0]
    L, Dinv, bad = factor_plain(H, n, padded(n, PLAIN_BLK), jitter)
    return L[:n, :n], Dinv, bad


# ---------------------------------------------------------------------------
# K3b: fused two-triangle solve
# ---------------------------------------------------------------------------

def cholesky_solve_blocked(L: torch.Tensor, Dinv: torch.Tensor,
                           B: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) X = B; B (n,) or (n, p) fp32, contiguous.  L may be
    a row-major view with a longer row stride (K3a returns the leading
    block of its padded buffer): the kernel reads it in place."""
    _need(Dinv, torch.float32, 2, "cholesky_solve_blocked")
    if L.dtype != torch.float32 or L.ndim != 2 or B.dtype != torch.float32:
        raise ValueError("cholesky_solve_blocked: L and B must be float32")
    if L.shape[0] != L.shape[1] or B.ndim not in (1, 2):
        raise ValueError("cholesky_solve_blocked: L must be square and B "
                         "a vector or a matrix")
    if _device_kind(L) == "cpu":
        return cholesky_solve_blocked_plain(L, Dinv, B)
    n = L.shape[0]
    blk = cuda_block()
    if Dinv.shape != (padded(n, blk), blk) or B.shape[0] != n:
        raise ValueError("cholesky_solve_blocked: shape mismatch")
    if L.stride(1) != 1 or L.stride(0) < n or not B.is_contiguous():
        raise ValueError("cholesky_solve_blocked: L must have unit column "
                         "stride and B must be contiguous")
    if not (L.device == Dinv.device == B.device):
        raise ValueError("cholesky_solve_blocked: L, Dinv and B must be on "
                         "one device")
    X = block_solve_cuda(L, B, fwd=Dinv, bwd=Dinv)
    cholesky_solve_blocked.launches += 1
    return X


def cholesky_solve_blocked_plain(L: torch.Tensor, Dinv: torch.Tensor,
                                 B: torch.Tensor) -> torch.Tensor:
    cholesky_solve_blocked_plain.calls += 1
    del Dinv
    vec = B.ndim == 1
    B2 = B[:, None] if vec else B
    Y = torch.linalg.solve_triangular(L, B2, upper=False)
    X = torch.linalg.solve_triangular(L.T, Y, upper=True)
    return X[:, 0] if vec else X


for _f in (cholesky_blocked, cholesky_solve_blocked):
    _f.launches = 0
for _f in (cholesky_blocked_plain, cholesky_solve_blocked_plain):
    _f.calls = 0
