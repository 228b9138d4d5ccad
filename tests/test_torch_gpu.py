"""The CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (``nvcc``): they are
marked ``gpu`` and skip elsewhere.  On the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have.)

Tolerances: float32 ``atol=rtol=1e-5`` (summation order only); bfloat16
``atol=2e-2`` after upcasting (the output rounds to bf16).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_resident, decode_attention_resident_plain)

pytestmark = pytest.mark.gpu

TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=2e-2, rtol=0.0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_kernel_matches_plain_version(cuda, dtype, dh):
    B, H, KvE, T = 4, 8, 2, 80
    rng = np.random.default_rng(dh)
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, B, T, KvE, dh),
                                                 np.float32))
    q, cache = q.to(cuda, dtype), cache.to(cuda, dtype)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    lengths = torch.tensor([0, 1, T, T + 1], dtype=torch.int32, device=cuda)
    rows = torch.tensor([5, 4, 0, 2, 3], dtype=torch.int32, device=cuda)
    before = decode_attention_resident.launches
    out = decode_attention_resident(q, k, v, lengths, rows)
    torch.cuda.synchronize()
    assert decode_attention_resident.launches == before + 1
    want = decode_attention_resident_plain(q, k, v, lengths, rows)
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    assert not out[0].any()                  # length 0 returns zeros


def test_kernel_rejects_unsupported_head_width(cuda):
    q = torch.zeros((1, 2, 48), device=cuda)
    k = torch.zeros((1, 1, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="dh"):
        decode_attention_resident(q, k, k, torch.ones(1, dtype=torch.int32,
                                                      device=cuda),
                                  torch.arange(2, device=cuda))
