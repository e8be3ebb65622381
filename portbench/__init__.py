"""The benchmark of strelka_tpu_torch: whole CLI jobs on one card."""
