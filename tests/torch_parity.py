"""Shared helpers of the test_torch_* parity tests (PyTorch port vs the
JAX package on the same numpy inputs)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (decided
    when the test runs, never at import, so every worker collects the same
    tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU interpret mode)")
    return torch.device("cuda")


def t(a, device="cpu") -> torch.Tensor:
    """numpy (or JAX) array -> torch tensor (copied)."""
    return torch.from_numpy(np.array(np.asarray(a), copy=True)).to(device)


def lsb_diff(a, b):
    """(max |a-b|, fraction of differing entries) of integer images."""
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return int(d.max()), float((d > 0).mean())
