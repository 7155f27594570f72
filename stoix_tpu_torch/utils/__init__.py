"""Utilities (counterpart of stoix_tpu/utils)."""
