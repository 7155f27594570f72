"""Build the port's CUDA sources with nvcc and bind their plain C entry points.

Each source under `csrc/` compiles on its own into a shared library in
`_build/` (git-ignored), named by the hash of the source, of every header
(`*.cuh`) beside it (csrc/flash_forward.cuh is the forward core both
flash-attention sources share) and of the flags, so an edited source or
header rebuilds and an unchanged one loads at once. Nothing is built at
import: a library builds inside the first call that launches one of its
kernels, or in `build_all`, which starts one nvcc per source at once and
waits for all of them.

Every entry point launches on the stream it is given and returns
`cudaGetLastError()`; `CudaLibrary.check` raises on a code other than 0.

nvcc runs with `-Xptxas -v`, and a library built in this process keeps
nvcc's output as `build_log`: the registers, spill stores and loads, and
shared memory of every kernel instance (`ptxas_report` picks those lines).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence, Tuple

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600


def _source_bytes(path: str) -> bytes:
    """The source and, after it, every header (`*.cuh`) in its directory, in
    name order."""
    directory = os.path.dirname(path)
    headers = sorted(name for name in os.listdir(directory) if name.endswith(".cuh"))
    parts = [path] + [os.path.join(directory, name) for name in headers]
    out = b""
    for part in parts:
        with open(part, "rb") as f:
            out += f.read()
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


class CudaLibrary:
    """One CUDA source, built once and loaded with ctypes.

    `entries` maps each C entry point to its ctypes argument types; every
    entry returns an int (a cudaError_t). `error_entry` names the function
    that turns such a code into a message."""

    def __init__(self, source: str, entries: Dict[str, Sequence[type]], error_entry: str):
        self.source = os.path.join(CSRC_DIR, source)
        self.entries = dict(entries)
        self.error_entry = error_entry
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log: Optional[str] = None  # nvcc's output, when built in this process
        self._lock = threading.Lock()

    def library_path(self) -> str:
        digest = hashlib.sha256(
            _source_bytes(self.source) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")

    def start_build(self) -> Optional[Tuple[subprocess.Popen, str]]:
        """Start nvcc on the source unless its library exists; returns the
        process and the temporary file it writes."""
        if self._lib is not None or os.path.exists(self.library_path()):
            return None
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp

    def finish_build(self, started: Optional[Tuple[subprocess.Popen, str]]) -> None:
        """Wait for a build `start_build` started; move its library into place."""
        if started is None:
            return
        proc, tmp = started
        try:
            output, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {self.source}:\n{output}")
            self.build_log = output
            os.replace(tmp, self.library_path())  # atomic: concurrent builds agree
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise RuntimeError(f"nvcc timed out building {self.source}") from None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load(self) -> ctypes.CDLL:
        """Build (if the hashed library is absent) and load the library."""
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(self.library_path())
                for name, argtypes in self.entries.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                error = getattr(lib, self.error_entry)
                error.argtypes = [ctypes.c_int]
                error.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def ptxas_report(self) -> list:
        """The `ptxas info` lines of `build_log` and their spill lines, in
        order (empty when the library was not built in this process)."""
        return [line.strip() for line in (self.build_log or "").splitlines()
                if "ptxas info" in line or "spill" in line]

    def check(self, code: int, what: str) -> None:
        if code != 0:
            message = getattr(self.load(), self.error_entry)(code).decode()
            raise RuntimeError(f"{what} launch failed: {message}")


def build_all(libraries: Sequence[CudaLibrary]) -> None:
    """Build every library with one nvcc each, all started together, then load them."""
    started = [lib.start_build() for lib in libraries]
    errors = []
    for lib, build in zip(libraries, started):
        try:
            lib.finish_build(build)
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        lib.load()
