"""Vanilla policy gradient: REINFORCE with a critic baseline (counterpart of
stoix_tpu/systems/vpg)."""
