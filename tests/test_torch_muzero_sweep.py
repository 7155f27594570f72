"""ff_mz and ff_sampled_mz of the PyTorch port end to end on the CPU at the
JAX sweep's budget, as tests/test_torch_search_sweep.py runs the AZ family:
a finite return and no B1 call (their n-step targets are plain ops)."""

import pytest

import torch_parity  # noqa: F401  (one intra-op thread, as every port test)
from test_torch_search_sweep import run_path


@pytest.mark.parametrize("path", ["ff_mz", "ff_sampled_mz"])
def test_each_muzero_path_runs_at_the_sweep_budget_without_b1(path, monkeypatch):
    run_path(path, monkeypatch)
