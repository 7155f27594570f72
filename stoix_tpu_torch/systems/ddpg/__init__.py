"""Deterministic-policy actor-critics: DDPG, TD3, D4PG (counterpart of stoix_tpu/systems/ddpg)."""
