"""PPO systems."""
