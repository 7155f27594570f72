"""stoix_tpu_torch — the PyTorch/CUDA port of stoix_tpu for NVIDIA Hopper.

Module paths mirror `stoix_tpu/`, so each counterpart is found by name. The
port imports torch, numpy and yaml, and nothing of JAX or of `stoix_tpu`.
Entry points run on CUDA unless the caller passes `device="cpu"`; every
kernel the JAX package wrote in Pallas for the TPU is a hand-written Hopper
kernel under `csrc/`, wrapped in `kernels/`.
"""
