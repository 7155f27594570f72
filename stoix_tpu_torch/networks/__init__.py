"""Networks (counterpart of stoix_tpu/networks)."""
