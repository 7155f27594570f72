"""Sebulba PPO systems."""
