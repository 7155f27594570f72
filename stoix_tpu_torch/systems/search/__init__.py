"""The search systems, AlphaZero and MuZero with their sampled variants
(counterpart of stoix_tpu/systems/search)."""
