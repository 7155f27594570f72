"""The port's kernel build (stoix_tpu_torch/kernels/build.py), on the CPU: no
nvcc is needed to name a library.

A library is named by the hash of its source, of every header (`*.cuh`)
beside it and of the flags, so an edited header rebuilds the libraries
instead of loading a stale one.
"""

import os

from stoix_tpu_torch.kernels import build
from stoix_tpu_torch.kernels import flash_attention as fa
from stoix_tpu_torch.kernels import flash_attention_chunk as fac


def test_library_path_follows_the_headers_beside_the_source(tmp_path):
    (tmp_path / "kernel.cu").write_text('#include "core.cuh"\nint x;\n')
    (tmp_path / "core.cuh").write_text("#pragma once\nint y;\n")
    (tmp_path / "other.cu").write_text("int w;\n")
    lib = build.CudaLibrary(str(tmp_path / "kernel.cu"), {}, error_entry="error_string")
    first = lib.library_path()
    assert first == lib.library_path()  # stable
    (tmp_path / "other.cu").write_text("int w2;\n")
    assert lib.library_path() == first  # another source: no rebuild
    (tmp_path / "core.cuh").write_text("#pragma once\nint y2;\n")
    second = lib.library_path()
    assert second != first  # an edited header rebuilds
    (tmp_path / "kernel.cu").write_text('#include "core.cuh"\nint x2;\n')
    assert lib.library_path() not in (first, second)


def test_flash_libraries_hash_the_forward_core():
    # Both flash-attention sources include csrc/flash_forward.cuh, so its
    # text is part of both names.
    with open(os.path.join(build.CSRC_DIR, "flash_forward.cuh"), "rb") as f:
        core = f.read()
    for library in (fa.LIBRARY, fac.LIBRARY):
        with open(library.source) as f:
            assert '#include "flash_forward.cuh"' in f.read()
        assert core in build._source_bytes(library.source)
