#!/usr/bin/env python3
"""Compare ptxas's report (registers, spills, shared memory) of every kernel
instance in the port's two flash-attention libraries against an earlier
version of their sources, on a machine with nvcc.

    python3 scripts/torch_ptxas_diff.py --old-dir results/old

`--old-dir` holds the earlier flash_attention.cu, flash_attention_chunk.cu and
flash_forward.cuh side by side (`git show <commit>:stoix_tpu_torch/csrc/...`),
in a git-ignored directory. All four builds start together, in a temporary
directory (a library already in `_build/` would print no ptxas report). Prints one JSON
line per library: the instances whose report changed, the reports of the
instances only the new sources build, the names of those only the old ones
build, and how many are unchanged; exits 1 if an instance both sides build
changed its report.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import ptxas_instances  # noqa: E402
from stoix_tpu_torch.kernels import build, flash_attention, flash_attention_chunk  # noqa: E402


def _instances(library) -> dict:
    """ptxas's records keyed by the kernel's own mangled name: the anonymous
    namespace's hash, which changes with the file's content, is cut off."""
    out = {}
    for rec in ptxas_instances(library.ptxas_report()):
        found = re.search(r"(flash_(?:forward|backward|chunk)_kernel.*)$", rec["kernel"])
        name = found.group(1) if found else rec["kernel"]
        out[name] = {key: value for key, value in rec.items() if key != "kernel"}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old-dir", required=True)
    args = parser.parse_args()
    with tempfile.TemporaryDirectory(prefix="ptxas_diff_") as build_dir:
        build.BUILD_DIR = build_dir
        return _compare(args.old_dir)


def _compare(old_dir: str) -> int:
    new = [flash_attention.LIBRARY, flash_attention_chunk.LIBRARY]
    old_dir = os.path.abspath(old_dir)
    old = [build.CudaLibrary(os.path.join(old_dir, os.path.basename(lib.source)), lib.entries,
                             lib.error_entry) for lib in new]
    started = [lib.start_build() for lib in new + old]
    for lib, proc in zip(new + old, started):
        lib.finish_build(proc)
    changed_any = False
    for new_lib, old_lib in zip(new, old):
        before, after = _instances(old_lib), _instances(new_lib)
        both = before.keys() & after.keys()
        changed = {name: {"old": before[name], "new": after[name]}
                   for name in both if before[name] != after[name]}
        changed_any |= bool(changed)
        print(json.dumps({
            "library": os.path.basename(new_lib.source), "unchanged": len(both) - len(changed),
            "changed": changed,
            "only_new": [{**after[name], "kernel": name} for name in sorted(after.keys() - both)],
            "only_old": sorted(before.keys() - both),
        }), flush=True)
    return 1 if changed_any else 0


if __name__ == "__main__":
    sys.exit(main())
