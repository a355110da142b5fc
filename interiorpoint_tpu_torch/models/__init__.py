"""models of interiorpoint_tpu_torch."""
