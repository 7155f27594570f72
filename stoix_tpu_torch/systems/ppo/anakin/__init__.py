"""Anakin PPO systems."""
