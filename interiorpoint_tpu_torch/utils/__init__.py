"""utils of interiorpoint_tpu_torch."""
