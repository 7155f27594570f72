"""MPO and V-MPO (counterpart of stoix_tpu/systems/mpo)."""
