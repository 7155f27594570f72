"""Reverse linear recurrence and truncated GAE on it: the Hopper CUDA kernel's
two entry points, their plain versions, and the wrappers that pick between
them by the tensors' device.

    acc_t = delta_t + weight_t * acc_{t+1},   acc_T = init,   t = T-1 ... 0

Replaces: stoix_tpu/ops/scan_kernels.py::pallas_linear_recurrence_reverse
(kernel body `_recurrence_kernel`), the Pallas TPU kernel behind
`system.multistep_impl: pallas`. The generic entry point (`KERNEL`) computes
the recurrence alone, in float32 or bfloat16. The GAE entry point
(`GAE_KERNEL`) computes truncated GAE in one launch: the recurrence plus the
elementwise producer (delta, weight) and consumer (targets) that XLA fuses
around the Pallas call in the JAX package's jitted GAE
(stoix_tpu/ops/multistep.py::truncated_generalized_advantage_estimation). On
the Anakin PPO main path GAE runs at [rollout_length, num_envs] = [16, 1024]
float32, once per update step, through the GAE entry point.

Bound on an H100: bytes. The generic kernel reads weight and delta once
(2·T·B elements), init once (B) and writes T·B outputs; GAE reads five
[T, B] inputs and writes two. At [16, 1024] float32 that is 0.06 µs and
0.14 µs at 3.35 TB/s, so the launch and one memory round trip set the time.

Design (csrc/linear_recurrence.cu): a block owns 32 columns. The time axis is
cut into stages, one 16-row stage over 8 warps for T ≤ 16 and 64-row stages
over 4 warps for a longer T; every warp loads rows of a stage into shared
memory and warp 0 folds it, one lane a column, with the float32 carry in a
register, while the next stage's loads are in flight. A stage costs one
memory round trip; [16, 1024] runs on 32 SMs. Row loads and stores coalesce;
the ragged edges are masked, not padded.

Rounding: XLA compiles the JAX package's `delta + weight * acc` into ONE fused
multiply-add (a single rounding), both in `_scan_reverse` and in the Pallas
kernel's interpret mode, and `r + discount * v_t` in GAE's delta likewise.
The kernel states each rounding with an `_rn` intrinsic, and the plain
versions below compute the same correctly rounded FMA exactly (`fma_f32`), so
all of them agree bitwise in float32.

Build: at first use `nvcc -gencode arch=compute_90a,code=sm_90a` compiles the
source into `_build/` (git-ignored), keyed by the hash of the source and the
flags, and the plain C entry points are bound with ctypes (kernels/build.py).

Counters: `KERNEL` and `GAE_KERNEL` each count the launches of one entry
point, and rise nowhere else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from stoix_tpu_torch.kernels.build import CudaLibrary

_ENTRY = {torch.float32: "linear_recurrence_reverse_f32",
          torch.bfloat16: "linear_recurrence_reverse_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary(
    "linear_recurrence.cu",
    {
        **{name: [_P] * 4 + [_I, _I, _P] for name in _ENTRY.values()},
        # r, discount, v_tm1, v_t, truncation (or null), lambda, advantages,
        # targets, T, B, stream
        "truncated_gae_f32": [_P] * 5 + [ctypes.c_float] + [_P] * 2 + [_I, _I, _P],
        "linear_recurrence_empty": [_I, _I, _P],  # the launch floor on the kernel's grid
    },
    error_entry="linear_recurrence_error_string",
)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`a * b + c` for float32 tensors with ONE rounding (IEEE fusedMultiplyAdd,
    round to nearest even), computed exactly in float64.

    The float64 product of two float32 values is exact; the float64 sum is
    off by `err`, which TwoSum recovers exactly. Rounding that sum to float32
    is then right except where it sits exactly halfway between two float32
    values while the exact result does not (double rounding); there it is
    moved one float64 ulp toward the exact result first."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    r64 = r.double()
    neighbour = torch.nextafter(r, torch.where(s > r64, math.inf, -math.inf).to(r.dtype))
    halfway = (s != r64) & (s == (r64 + neighbour.double()) * 0.5) & (err != 0)
    toward = torch.nextafter(s, torch.where(err > 0, math.inf, -math.inf).to(s.dtype))
    return torch.where(halfway, toward, s).float()


def plain_linear_recurrence_reverse(
    weight_t: torch.Tensor, delta_t: torch.Tensor, init: torch.Tensor
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: a sequential loop over time,
    a float32 accumulator updated by one fused multiply-add per step, each row
    rounded once to `delta_t.dtype`. `init` is cast to `delta_t.dtype` first,
    as the TPU kernel does."""
    t_len = delta_t.shape[0]
    w = weight_t.reshape(t_len, -1).to(torch.float32)
    d = delta_t.reshape(t_len, -1).to(torch.float32)
    acc = init.reshape(-1).to(delta_t.dtype).to(torch.float32)
    out = torch.empty(d.shape, dtype=delta_t.dtype, device=delta_t.device)
    for t in range(t_len - 1, -1, -1):
        acc = fma_f32(w[t], acc, d[t])
        out[t] = acc
    return out.reshape(delta_t.shape)


def plain_truncated_gae(
    r_t: torch.Tensor, discount_t: torch.Tensor, v_tm1: torch.Tensor, v_t: torch.Tensor,
    truncation_t: Optional[torch.Tensor], lambda_: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GAE entry point's arithmetic in plain PyTorch, in its order and
    roundings, on time-major float32 [T, ...] inputs (`truncation_t` None for
    none): delta = (r + discount·v_t) − v_tm1 with one FMA; weight =
    (discount·λ)·(1 − truncation); the recurrence from acc_T = 0; target =
    v_tm1 + advantage. Returns (advantages, targets)."""
    lam = torch.as_tensor(lambda_, dtype=torch.float32)
    delta = fma_f32(discount_t, v_t, r_t) - v_tm1
    weight = discount_t * lam
    if truncation_t is not None:
        weight = weight * (1.0 - truncation_t)
    advantages = plain_linear_recurrence_reverse(weight, delta, torch.zeros_like(delta[0]))
    return advantages, v_tm1 + advantages


def _stream(device: torch.device) -> int:
    # The raw cudaStream_t of the device's current stream, without building a
    # torch.cuda.Stream object (as Triton's launcher reads it).
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(entry, device: torch.device, *args) -> int:
    """Call a C entry point on `device`'s current stream. A launch goes to the
    calling thread's current device, so only a tensor on another device pays
    for a device switch."""
    if device.index == torch.cuda.current_device():
        return entry(*args, _stream(device))
    with torch.cuda.device(device):
        return entry(*args, _stream(device))


class LinearRecurrenceKernel:
    """The generic entry point, with a launch counter.

    `launches` rises by one for every kernel launch and nowhere else."""

    name = "linear_recurrence_reverse"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(
        self, weight_t: torch.Tensor, delta_t: torch.Tensor, init: torch.Tensor
    ) -> torch.Tensor:
        """Launch on CUDA tensors: `weight_t`, `delta_t` [T, ...] of one dtype
        (float32 or bfloat16), contiguous, on one device; `init` one step."""
        if weight_t.dtype != delta_t.dtype or delta_t.dtype not in _ENTRY:
            raise TypeError(
                f"linear recurrence kernel takes float32 or bfloat16 weight/delta of one "
                f"dtype, got {weight_t.dtype} and {delta_t.dtype}"
            )
        if weight_t.shape != delta_t.shape:
            raise ValueError(f"weight {tuple(weight_t.shape)} != delta {tuple(delta_t.shape)}")
        device = delta_t.device
        if device.type != "cuda" or weight_t.device != device or init.device != device:
            raise ValueError("linear recurrence kernel needs all tensors on one CUDA device")
        if not (weight_t.is_contiguous() and delta_t.is_contiguous()):
            raise ValueError("linear recurrence kernel needs contiguous weight and delta")
        t_len = delta_t.shape[0]
        b_len = delta_t.numel() // t_len if t_len else 0
        if init.numel() != b_len:
            raise ValueError(f"init has {init.numel()} elements, one step has {b_len}")
        if init.dtype != delta_t.dtype or not init.is_contiguous():
            init = init.to(delta_t.dtype).contiguous()
        out = torch.empty_like(delta_t)
        if out.numel() == 0:
            return out
        code = _launch(
            getattr(LIBRARY.load(), _ENTRY[delta_t.dtype]), device,
            weight_t.data_ptr(), delta_t.data_ptr(), init.data_ptr(), out.data_ptr(),
            t_len, b_len,
        )
        LIBRARY.check(code, "linear recurrence kernel")
        self.launches += 1
        return out


class TruncatedGaeKernel:
    """The GAE entry point, with a launch counter.

    `launches` rises by one for every kernel launch and nowhere else."""

    name = "truncated_gae"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(
        self, r_t: torch.Tensor, discount_t: torch.Tensor, v_tm1: torch.Tensor,
        v_t: torch.Tensor, truncation_t: Optional[torch.Tensor], lambda_: float,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch on CUDA tensors: float32 [T, ...] inputs of one shape,
        contiguous, on one device (`truncation_t` may be None); returns
        (advantages, targets)."""
        inputs = [r_t, discount_t, v_tm1, v_t] + ([] if truncation_t is None else [truncation_t])
        if any(x.dtype != torch.float32 for x in inputs):
            raise TypeError(
                f"GAE kernel takes float32 inputs, got {[str(x.dtype) for x in inputs]}")
        if any(x.shape != r_t.shape for x in inputs):
            raise ValueError(f"GAE kernel inputs disagree in shape: "
                             f"{[tuple(x.shape) for x in inputs]}")
        device = r_t.device
        if device.type != "cuda" or any(x.device != device for x in inputs):
            raise ValueError("GAE kernel needs all tensors on one CUDA device")
        if not all(x.is_contiguous() for x in inputs):
            raise ValueError("GAE kernel needs contiguous inputs")
        advantages, targets = torch.empty_like(r_t), torch.empty_like(r_t)
        if r_t.numel() == 0:
            return advantages, targets
        t_len = r_t.shape[0]
        code = _launch(
            LIBRARY.load().truncated_gae_f32, device,
            r_t.data_ptr(), discount_t.data_ptr(), v_tm1.data_ptr(), v_t.data_ptr(),
            None if truncation_t is None else truncation_t.data_ptr(),
            # The float32 value of lambda, as the plain version rounds it.
            float(np.float32(lambda_)), advantages.data_ptr(), targets.data_ptr(),
            t_len, r_t.numel() // t_len,
        )
        LIBRARY.check(code, "GAE kernel")
        self.launches += 1
        return advantages, targets


KERNEL = LinearRecurrenceKernel()
GAE_KERNEL = TruncatedGaeKernel()
COUNTERS = (KERNEL, GAE_KERNEL)


def linear_recurrence_reverse(
    weight_t: torch.Tensor, delta_t: torch.Tensor, init: torch.Tensor
) -> torch.Tensor:
    """The kernel on a CUDA tensor (it launches or raises); its plain version
    on a CPU tensor."""
    if delta_t.device.type == "cuda":
        return KERNEL(weight_t, delta_t, init)
    if delta_t.device.type == "cpu":
        return plain_linear_recurrence_reverse(weight_t, delta_t, init)
    raise ValueError(f"no linear recurrence kernel for device {delta_t.device}")


def truncated_gae(
    r_t: torch.Tensor, discount_t: torch.Tensor, v_tm1: torch.Tensor, v_t: torch.Tensor,
    truncation_t: Optional[torch.Tensor], lambda_: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncated GAE in one launch on CUDA tensors (it launches or raises); its
    plain version on CPU tensors."""
    if r_t.device.type == "cuda":
        return GAE_KERNEL(r_t, discount_t, v_tm1, v_t, truncation_t, lambda_)
    if r_t.device.type == "cpu":
        return plain_truncated_gae(r_t, discount_t, v_tm1, v_t, truncation_t, lambda_)
    raise ValueError(f"no GAE kernel for device {r_t.device}")
