"""Advantage-weighted regression (counterpart of stoix_tpu/systems/awr)."""
