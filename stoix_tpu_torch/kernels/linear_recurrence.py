"""Reverse linear recurrence: the Hopper CUDA kernel, its plain version, and
the wrapper that picks between them by the tensors' device.

    acc_t = delta_t + weight_t * acc_{t+1},   acc_T = init,   t = T-1 ... 0

Replaces: stoix_tpu/ops/scan_kernels.py::pallas_linear_recurrence_reverse
(kernel body `_recurrence_kernel`), the Pallas TPU kernel behind
`system.multistep_impl: pallas`. On the Anakin PPO main path it evaluates GAE
at [rollout_length, num_envs] = [16, 1024] float32, once per update step.

Bound on an H100: bytes. It reads weight and delta once (2·T·B elements),
init once (B) and writes T·B outputs; 2 flops per element is nothing beside
that. At [16, 1024] float32 that is 196 KiB, about 0.06 µs at 3.35 TB/s, so
the launch itself (a few µs) dominates; making it faster (more columns in
flight per thread, CUDA graphs around the update step) is later work.

Design (csrc/linear_recurrence.cu): one thread per flattened column walks
t = T-1 ... 0 with the float32 carry in a register, where the TPU kernel
carried it across a sequential grid in VMEM scratch. Row loads and stores
coalesce; the ragged batch edge is masked, not padded.

Rounding: XLA compiles the JAX package's `delta + weight * acc` into ONE fused
multiply-add (a single rounding), both in `_scan_reverse` and in the Pallas
kernel's interpret mode. The kernel states that rounding explicitly with
`__fmaf_rn(weight, acc, delta)`, and the plain version below computes the same
correctly rounded FMA exactly (`fma_f32`), so all of them agree bitwise in
float32.

Build: at first use `nvcc -gencode arch=compute_90a,code=sm_90a` compiles the
source into `_build/` (git-ignored), keyed by the hash of the source and the
flags, and the plain C entry points are bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "linear_recurrence.cu")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_ENTRY = {torch.float32: "linear_recurrence_reverse_f32",
          torch.bfloat16: "linear_recurrence_reverse_bf16"}


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


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the linear-recurrence CUDA kernel cannot be built")


class LinearRecurrenceKernel:
    """The compiled kernel: built and loaded once, with a launch counter.

    `launches` rises by one for every kernel launch and nowhere else."""

    def __init__(self) -> None:
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> str:
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return os.path.join(BUILD_DIR, f"liblinear_recurrence_{digest}.so")

    def build(self) -> ctypes.CDLL:
        """Compile (if the hashed library is absent) and load the kernel."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            path = self.library_path()
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    subprocess.run(
                        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                        check=True, capture_output=True, text=True, timeout=600,
                    )
                    os.replace(tmp, path)  # atomic: concurrent builds agree
                except subprocess.CalledProcessError as err:
                    raise RuntimeError(
                        f"nvcc failed building {SOURCE}:\n{err.stdout}\n{err.stderr}"
                    ) from err
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(path)
            for name in _ENTRY.values():
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.linear_recurrence_error_string.argtypes = [ctypes.c_int]
            lib.linear_recurrence_error_string.restype = ctypes.c_char_p
            self._lib = lib
            return lib

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
        init_c = init.reshape(-1).to(delta_t.dtype).contiguous()
        if init_c.numel() != b_len:
            raise ValueError(f"init has {init_c.numel()} elements, one step has {b_len}")
        out = torch.empty_like(delta_t)
        if out.numel() == 0:
            return out
        lib = self.build()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            code = getattr(lib, _ENTRY[delta_t.dtype])(
                weight_t.data_ptr(), delta_t.data_ptr(), init_c.data_ptr(), out.data_ptr(),
                t_len, b_len, stream,
            )
        if code != 0:
            raise RuntimeError(
                "linear recurrence kernel launch failed: "
                + lib.linear_recurrence_error_string(code).decode()
            )
        self.launches += 1
        return out


KERNEL = LinearRecurrenceKernel()


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
