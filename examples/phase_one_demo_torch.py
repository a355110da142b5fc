"""Phase-one feasibility walkthrough of the PyTorch port (counterpart of
examples/phase_one_demo.py:17-60, the same instances, seeds and
settings).

Finds interior points of polyhedra, certifies emptiness, and shows the
solver pipeline LP → phase one → barrier.  Runs on the GPU; ``--cpu``
solves on the CPU.

    python examples/phase_one_demo_torch.py [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None, out=None):
    """Run the walkthrough; ``out`` (a dict), when given, receives each
    section's point and s."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    out = {} if out is None else out

    from interiorpoint_tpu_torch import (PhaseOne, PhaseOneSolver,
                                         default_device)
    device = "cpu" if args.cpu else default_device()

    print("=== Feasible polyhedron (triangle with slack) ===")
    G = np.array([[1.0, 3], [1, 1], [-1, 0], [0, -1]])
    h = np.array([9.0, 5, 0, 0])
    x, s, warn = PhaseOne(G, h, mu=15, device=device).solve()
    print(f"x = {x},  s = {s:.4f} (s < 0 → strictly feasible)")
    print(f"max(Gx - h) = {np.max(G @ x - h):.4f}")
    out["triangle"] = dict(x=x, s=s, max_viol=float(np.max(G @ x - h)))

    print("\n=== Provably empty polyhedron ===")
    G = np.array([[3.0, -1], [-1, 5], [-1, 0], [0, -1]])
    h = np.array([-2.0, 1.5, 0, 0])
    x, s, warn = PhaseOne(G, h, mu=15, device=device).solve()
    print(f"s = {s:.4f} (s > 0 → certified empty)")
    out["empty"] = dict(x=x, s=s, G=G, h=h)

    print("\n=== High-dimensional random system (200 × 1000) ===")
    rng = np.random.default_rng(0)
    m, n = 200, 1000
    G = rng.uniform(-10, 10, (m, n))
    h = G @ rng.uniform(-5, 5, n) + 1
    x, s, warn = PhaseOne(G, h, mu=15, device=device).solve()
    print(f"s = {s:.4f},  max(Gx - h) = {np.max(G @ x - h):.4f}")
    out["random"] = dict(x=x, s=s, max_viol=float(np.max(G @ x - h)))

    print("\n=== Current API: inequality block + bounds ===")
    n, k = 40, 60
    C = rng.uniform(-2, 2, (k, n))
    d = C @ rng.uniform(-0.5, 0.5, n) + 0.2
    p1 = PhaseOneSolver(C=C, d=d, lower_bound=-3, upper_bound=3,
                        x0=np.full(n, 2.5), suppress_print=True, tol=0.0,
                        max_outer_iters=50, max_inner_iters=200, t0=0.01,
                        device=device)
    x, s = p1.solve()
    print(f"s = {s:.4f}, max(Cx - d) = {np.max(C @ x - d):.4f}, "
          f"|x|max = {np.abs(x).max():.4f}")
    out["bounded"] = dict(x=x, s=s, max_viol=float(np.max(C @ x - d)),
                          x_absmax=float(np.abs(x).max()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
