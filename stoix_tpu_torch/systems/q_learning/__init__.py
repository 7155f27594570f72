"""Value-based systems: the DQN family and PQN (counterpart of stoix_tpu/systems/q_learning)."""
