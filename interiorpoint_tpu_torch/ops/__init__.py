"""ops of interiorpoint_tpu_torch."""
