"""Sebulba's host-side plumbing (counterpart of stoix_tpu/sebulba)."""
