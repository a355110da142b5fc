"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into ONE shared
library with a plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o _build/obj_<hash>/<name>.o csrc/<name>.cu
    nvcc -shared -o _build/libiptorch_<hash>.so _build/obj_<hash>/*.o

The library is built at first use into ``interiorpoint_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the sources, so a fresh
checkout builds it on the first kernel launch.  No ``--use_fast_math``:
the fp32 factor needs IEEE ``sqrt`` and division.  No PyTorch headers and
no ``ninja``: the build takes seconds.

Every C entry takes its stream last and returns ``cudaGetLastError()``;
``launch`` raises on a non-zero return and counts launches per entry.
The launch geometry lives in the CUDA sources alone: what a caller must
size (workspaces, the factor's block edge) it asks the library through
``query``.
Nothing here falls back to another path: a missing ``nvcc`` or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_double)

# C entry -> argument types (the trailing stream argument is added below).
SIGNATURES = {
    # rows.cu
    "ip_c_matvec": [_P, _P, _P, _P, _I, _I],
    "ip_ct_matvec": [_P, _P, _P, _P, _I, _I],
    "ip_pd_pass1": [_P] * 15 + [_I, _I],
    "ip_pd_rhs": [_P] * 8 + [_I] + [_P] * 5 + [_I, _I],
    "ip_pd_ds": [_P] * 11 + [_I],
    "ip_pd_sigma": [_P] * 10 + [_I],
    "ip_pd_update": [_P] * 20 + [_I, _I],
    "ip_nt_pass1": [_P] * 8 + [_I, _I],
    "ip_nt_sweep": [_P, _P, _P, _I, _P, _P, _D, _P, _P, _I] + [_P] * 5
    + [_I],
    # gram.cu
    "ip_gram": [_P, _I] + [_P] * 4 + [_I] * 2,
    "ip_equilibrate": [_P, _I, _P, _P, _I],
    "ip_equilibrate64": [_P, _I, _P, _P, _I],
    # hop.cu (the fused operator; the refined solve, one cooperative
    # launch)
    "ip_h_apply": [_P] * 7 + [_I, _I],
    "ip_refined_solve": [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P,
                         _P, _P, _I, _D, _D] + [_P] * 7 + [_I, _I],
    "ip_precond_apply": [_I, _P, _I, _P, _P, _I, _P, _P, _P, _I],
    # chol.cu (the factor and the inverse: one cooperative launch each)
    "ip_chol_factor": [_P, _I, _I, _D, _P, _I, _P, _P, _P, _P, _I],
    "ip_chol_factor64": [_P, _I, _I, _D, _P, _I, _P, _P, _P, _P, _I],
    "ip_chol_invert": [_P, _P, _P, _P, _I, _P],
    "ip_chol_invert64": [_P, _P, _P, _P, _I, _P],
    "ip_pivot_floor": [_P, _I, _I, _D, _P, _P],
    "ip_w_solve": [_P, _I, _I, _P, _P, _P],
    "ip_block_solve": [_P, _I, _I, _I] + [_P] * 5 + [_I, _P, _I],
    # csolve.cu (the solve at p = 1: one launch of one cluster)
    "ip_block_solve_column": [_P, _I, _I, _I] + [_P] * 5,
    # wsolve.cu (the solve at p > 1: one launch of thread-block clusters)
    "ip_block_solve_wide": [_P, _I, _I, _I] + [_P] * 5 + [_I, _P],
    # ldl.cu
    "ip_ldl_factor": [_P, _I, _D] + [_P] * 4 + [_I] + [_P] * 4,
    "ip_ns_refresh": [_P, _P, _I, _P, _P, _P, _P],
    "ip_gram_tn": [_P, _I, _P, _P],
    "ip_k2_decide": [_P] * 3 + [_I, _P],
    # cones.cu
    "ip_socp_pass1": [_P] * 11 + [_I] * 3,
    "ip_socp_gcone": [_P] * 8 + [_I] * 3,
    "ip_socp_lscoef": [_P] * 4 + [_I] * 2,
    "ip_socp_dots": [_P] * 5 + [_I],
    "ip_socp_stats": [_P] * 7,
    "ip_socp_sweep": [_P] * 6 + [_I, _P, _P, _D, _P, _P, _I] + [_P] * 6
    + [_I],
    # kkt.cu
    "ip_kkt_schur64": [_P, _I, _P, _P, _P, _I, _I],
    "ip_kkt_gram64": [_P, _P, _P, _I, _I],
    # kktdir.cu (K5's direction or kkt_solve, one cooperative launch)
    "ip_kkt_direction": [_P, _P, _I, _P, _P, _P, _I] + [_P] * 11 + [_I] * 6
    + [_D] * 4,
}

# Host-side queries of the launch geometry: name -> argument types.
QUERIES = {
    "ip_rows_ws_bytes": [_I, _I],   # workspace of rows.cu's entries (k, r)
    "ip_pd_ws_bytes": [_I, _I],     # workspace of K1's passes (k, r)
    "ip_h_ws_bytes": [_I, _I],      # workspace of ip_h_apply (m, r)
    "ip_refined_solve_ws_bytes": [_I, _I],  # of ip_refined_solve (m, r)
    "ip_sweep_ws_bytes": [_I, _I],  # workspace of ip_nt_sweep (k, J)
    "ip_sweep_rows": [],            # rows per block of ip_nt_sweep
    "ip_gram_ws_bytes": [_I, _I],   # workspace of ip_gram (k, r)
    "ip_chol_block": [],            # block edge of chol.cu
    "ip_chol_flag_words": [_I],     # flag words of ip_chol_factor (np)
    "ip_block_solve_flags": [_I] * 3,  # flag words of ip_block_solve
                                       # (n, p, te)
    "ip_ldl_block": [],             # tile edge of ldl.cu's LDL factor
    "ip_ldl_flag_words": [_I],      # flag words of ip_ldl_factor (np)
    "ip_ldl_ws_floats": [],         # workspace of ip_ldl_factor
    "ip_ns_refresh_ws_floats": [_I],  # workspace of ip_ns_refresh (np)
    "ip_socp_ws_bytes": [_I] * 3,   # workspace of the G pass (K, M, r)
    "ip_socp_sweep_ws_bytes": [_I, _I],  # workspace of ip_socp_sweep (K, J)
    "ip_socp_sweep_cones": [],      # cones per block of ip_socp_sweep
    "ip_kkt_gram64_ws_bytes": [_I, _I],  # workspace of ip_kkt_gram64 (r, pe)
    "ip_kkt_direction_ws_bytes": [_I, _I],  # of ip_kkt_direction (r, pe)
}

# Launches of each C entry (one per call of ``launch``).
LAUNCHES: Counter = Counter()

_lib = None
build_seconds = None


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libiptorch_{source_hash()}.so"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled at first "
            "use and need the CUDA toolkit (set CUDA_HOME)")
    return found


def build() -> Path:
    """Compile the library if this source hash has not been built yet:
    one ``nvcc -c`` per source, all at once, then one link.  Returns its
    path; records the wall time of the build in ``build_seconds``."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    tag = f"{source_hash()}.{os.getpid()}"
    obj_dir = BUILD_DIR / f"obj_{tag}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    objs = [obj_dir / (p.stem + ".o") for p in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                               str(p)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for p, o in zip(srcs, objs)]
    results = [(p, *proc.communicate(), proc.returncode)
               for p, proc in zip(srcs, procs)]
    failed = [f"{p.name} ({rc}):\n{so}\n{se}"
              for p, so, se, rc in results if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    warnings = "\n".join(se.strip() for _, _, se, _ in results
                         if se.strip())
    if warnings:
        print(warnings)
    os.replace(tmp, out)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return out


def lib():
    """The loaded library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(args) + [_P]
            fn.restype = ctypes.c_int
        for name, args in QUERIES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_size_t
        _lib = handle
    return _lib


@functools.lru_cache(maxsize=None)
def query(name: str, *args: int) -> int:
    """Value of the geometry query ``name`` (see ``QUERIES``)."""
    return int(getattr(lib(), name)(*args))


# the current stream's handle: PyTorch's raw query where it has one (the
# public ``torch.cuda.current_stream().cuda_stream`` builds a Stream object
# on every call; chip_ab.py --k3b1 times both on the card's host, PERF.md)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_ENTRIES = {}


def current_stream() -> int:
    """The handle of the current CUDA stream of the current device."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream; raise on a CUDA error.
    Tensor arguments pass their data pointer (None passes NULL)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = getattr(lib(), name)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    rc = fn(*conv, current_stream())
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    LAUNCHES[name] += 1


def reset_launches() -> None:
    LAUNCHES.clear()
