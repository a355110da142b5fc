"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The suite runs under pytest-xdist with several workers on one machine, so
each worker keeps torch to one intra-op thread.  Inputs are made with
numpy from a seed and handed to both packages as arrays.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def rel(a, b) -> float:
    """Infinity-norm relative difference of two array-likes."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def np_of(t) -> np.ndarray:
    """numpy copy of a torch tensor or JAX array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def pd_instance(seed, k, r, quad=False):
    """Inequality-form LP/QP with a strictly feasible z0 and a known dual
    point (the instance family of tests/test_pallas_pd.py)."""
    rng = np.random.default_rng(seed)
    C = rng.uniform(-2, 2, (k, r))
    zf = rng.uniform(-0.5, 0.5, r)
    d = C @ zf + rng.uniform(0.3, 1.2, k)
    lamt = rng.uniform(0.1, 1.0, k)
    q = -C.T @ lamt
    P = None
    if quad:
        M = rng.uniform(-1, 1, (r, r))
        P = M.T @ M + np.eye(r)
    z0 = zf
    s0 = np.maximum(d - C @ z0, 1e-2)
    lam0 = np.clip(1.0 / s0, 1e-6, 1e6)
    return C, d, q, P, z0, s0, lam0


def t64(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))
