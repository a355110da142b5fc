"""The port's copy of utils/generators.py gives the JAX package's arrays."""
import numpy as np
import pytest

import torch_helpers  # noqa: F401  (thread setting)
from interiorpoint_tpu.utils import generators as gen_jax
from interiorpoint_tpu_torch.utils import generators as gen_torch


@pytest.mark.parametrize("name,n", [("generate_lp", 50),
                                    ("generate_qp", 40),
                                    ("generate_socp", 30),
                                    ("generate_lasso", 20)])
def test_generators_identical(name, n):
    a = getattr(gen_jax, name)(n, rng=np.random.RandomState(7))
    b = getattr(gen_torch, name)(n, rng=np.random.RandomState(7))
    assert a.keys() == b.keys()
    for key in a:
        va, vb = a[key], b[key]
        if isinstance(va, list):
            assert len(va) == len(vb)
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
