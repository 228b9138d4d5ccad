"""The port's flash-decode against the JAX package's Pallas kernel.

On the CPU the port's ``decode_attention_resident`` runs its plain PyTorch
version (the CUDA kernel is held against that version on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``); the JAX kernel runs in
interpret mode, as its own tests run it.  Inputs are made with numpy from
a seed and handed to both.  Tolerance: ``atol=rtol=1e-5`` in float32 — the
two sum in different orders and nothing else differs.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import (
    decode_attention_resident as jax_decode_resident)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    decode_attention_resident, decode_attention_resident_plain)

B, H, KvE, T, DH = 3, 8, 2, 64, 16
G = H // KvE
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, KvE, T, DH)).astype(np.float32)
    v = rng.standard_normal((B, KvE, T, DH)).astype(np.float32)
    return rng, q, k, v


def _rows(kind, rng):
    if kind == "identity":
        return np.arange(H, dtype=np.int32)
    if kind == "group_perm":
        # whole KV groups in a random order, each in a random inner order
        groups = rng.permutation(KvE)
        return np.concatenate([g * G + rng.permutation(G)
                               for g in groups]).astype(np.int32)
    return rng.choice(H, size=3, replace=False).astype(np.int32)   # R=3


@pytest.mark.parametrize("lengths", [(0, 1, 37), (64, 65, 37)])
@pytest.mark.parametrize("kind", ["identity", "group_perm", "partial"])
def test_plain_matches_interpreted_pallas_kernel(lengths, kind):
    rng, q, k, v = _inputs(len(kind) + lengths[0])
    rows = _rows(kind, rng)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jax_decode_resident(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        jnp.asarray(rows), interpret=True))
    got = decode_attention_resident(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), torch.from_numpy(rows))
    assert got.shape == (B, len(rows), DH)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if 0 in lengths:
        assert not got[lengths.index(0)].any()     # length 0 returns zeros


def test_bshd_wrapper_matches_jax_twin():
    """Model layout, strided cache view and the inv_rows scatter."""
    rng, q, k, v = _inputs(1)
    q4 = q[:, None]                                        # (B,1,H,dh)
    kc = np.ascontiguousarray(k.transpose(0, 2, 1, 3))      # (B,T,KvE,dh)
    vc = np.ascontiguousarray(v.transpose(0, 2, 1, 3))
    lens = np.asarray([5, 64, 65], np.int32)
    rows = _rows("group_perm", rng)
    inv = np.argsort(rows).astype(np.int32)
    want = np.asarray(jops.decode_attention_resident_bshd(
        jnp.asarray(q4), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        jnp.asarray(rows), inv_rows=jnp.asarray(inv)))
    got = ops.decode_attention_resident_bshd(
        torch.from_numpy(q4), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lens), torch.from_numpy(rows),
        inv_rows=torch.from_numpy(inv))
    assert got.shape == (B, 1, H, DH)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dense_oracle_matches_reference_and_plain_version():
    """``ref.decode_attention_ref`` against the JAX oracle, and the plain
    version with identity rows against it (valid lengths 1..T)."""
    _, q, k, v = _inputs(2)
    lens = np.asarray([1, 40, 64], np.int32)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    qt, kt, vt, lt = (torch.from_numpy(a) for a in (q, k, v, lens))
    np.testing.assert_allclose(ref.decode_attention_ref(qt, kt, vt, lt)
                               .numpy(), want, **TOL)
    plain = decode_attention_resident_plain(
        qt, kt, vt, lt, torch.arange(H, dtype=torch.int32))
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, q, k, v = _inputs(3)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    lens = torch.full((B,), 4, dtype=torch.int32)
    rows = torch.arange(H, dtype=torch.int32)
    with pytest.raises(ValueError, match="KvE"):
        decode_attention_resident(qt, kt[..., :8], vt, lens, rows)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        decode_attention_resident(qt, kt, vt, lens[:2], rows)
    with pytest.raises(ValueError, match="group"):
        decode_attention_resident(qt, kt[:, :1].expand(B, 3, T, DH),
                                  vt[:, :1].expand(B, 3, T, DH), lens, rows)
