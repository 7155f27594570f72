"""Batched MCTS (counterpart of stoix_tpu/search)."""
