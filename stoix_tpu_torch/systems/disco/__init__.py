"""Disco-RL, an agent trained by a meta update rule (counterpart of
stoix_tpu/systems/disco)."""
