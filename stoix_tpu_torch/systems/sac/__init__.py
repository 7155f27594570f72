"""Soft actor-critic (counterpart of stoix_tpu/systems/sac)."""
