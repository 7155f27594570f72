"""SPO, Sequential Monte Carlo Policy Optimisation (counterpart of
stoix_tpu/systems/spo)."""
