"""Systems (counterpart of stoix_tpu/systems)."""
