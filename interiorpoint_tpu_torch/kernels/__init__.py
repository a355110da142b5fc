"""kernels of interiorpoint_tpu_torch."""
