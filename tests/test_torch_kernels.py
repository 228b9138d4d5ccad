"""The port's flash-decode kernels against the JAX package's Pallas ones.

On the CPU each of the port's four wrappers (linear, int8, paged,
int8-paged) runs its plain PyTorch version (the CUDA kernels are held
against those versions on the card by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``); the JAX kernels run in interpret mode, as
their own tests run them.  Inputs are made with numpy from
a seed and handed to both.  Tolerance: ``atol=rtol=1e-5`` in float32 — the
two sum in different orders and nothing else differs.
"""
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import (
    decode_attention_int8_paged_resident as jax_decode_i8_paged,
    decode_attention_int8_resident as jax_decode_i8,
    decode_attention_paged_resident as jax_decode_paged,
    decode_attention_resident as jax_decode_resident)
from repro.models.layers import _q8 as jax_q8
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    decode_attention_int8_paged_resident, decode_attention_int8_resident,
    decode_attention_paged_resident, decode_attention_resident,
    decode_attention_resident_plain)
from repro_torch.models.layers import _q8

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


# ------------------------------------------------ int8, paged, int8-paged
LENGTHS = [(0, 1, 37), (64, 65, 37)]     # {0, 1, T, T + 1} and a middle one


def _quantized(x):
    """int8 values and scales of ``x`` through the JAX package's jitted
    ``_q8`` (the port's ``_q8`` equals it bit for bit, tested below), as
    numpy arrays for both packages."""
    qq, sc = jax.jit(jax_q8)(jnp.asarray(x))
    return np.array(qq), np.array(sc)


def _pages(rng, k, v, P, lengths):
    """Scatter a (B, KvE, T, dh) cache into a scrambled page pool
    (n_pages, KvE, P, dh): a random permutation of the pool, with -1
    entries past each row's live pages clamped to 0 as callers do."""
    n_log = T // P
    n_pages = B * n_log + 3
    perm = rng.permutation(n_pages)[:B * n_log].reshape(B, n_log)
    pool_k = rng.standard_normal((n_pages,) + (KvE, P, DH)).astype(k.dtype)
    pool_v = rng.standard_normal(pool_k.shape).astype(v.dtype)
    for b in range(B):
        for i in range(n_log):
            pool_k[perm[b, i]] = k[b, :, i * P:(i + 1) * P]
            pool_v[perm[b, i]] = v[b, :, i * P:(i + 1) * P]
    live = [-(-min(max(n, 0), T) // P) for n in lengths]
    pmap = np.where(np.arange(n_log)[None, :] < np.asarray(live)[:, None],
                    perm, -1).astype(np.int32)
    return pool_k, pool_v, np.maximum(pmap, 0)


@pytest.mark.parametrize("lengths", LENGTHS)
@pytest.mark.parametrize("kind", ["identity", "group_perm", "partial"])
def test_int8_plain_matches_interpreted_pallas_kernel(lengths, kind):
    rng, q, k, v = _inputs(10 + len(kind) + lengths[0])
    rows = _rows(kind, rng)
    lens = np.asarray(lengths, np.int32)
    (kq, ks), (vq, vs) = _quantized(k), _quantized(v)
    want = np.asarray(jax_decode_i8(
        *map(jnp.asarray, (q, kq, ks, vq, vs, lens, rows)), interpret=True))
    got = decode_attention_int8_resident(
        *map(torch.from_numpy, (q, kq, ks, vq, vs, lens, rows)))
    assert got.shape == (B, len(rows), DH)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


@pytest.mark.parametrize("P", [8, 16, 32])
@pytest.mark.parametrize("lengths", LENGTHS)
@pytest.mark.parametrize("kind", ["identity", "group_perm", "partial"])
def test_paged_plain_matches_interpreted_pallas_kernel(P, lengths, kind):
    rng, q, k, v = _inputs(20 + P + len(kind) + lengths[0])
    rows = _rows(kind, rng)
    lens = np.asarray(lengths, np.int32)
    pk, pv, pmap = _pages(rng, k, v, P, lengths)
    want = np.asarray(jax_decode_paged(
        *map(jnp.asarray, (q, pk, pv, lens, pmap, rows)), interpret=True))
    got = decode_attention_paged_resident(
        *map(torch.from_numpy, (q, pk, pv, lens, pmap, rows)))
    assert got.shape == (B, len(rows), DH)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the pages hold the linear cache: the same result as the linear kernel
    lin = decode_attention_resident(*map(torch.from_numpy,
                                         (q, k, v, lens, rows)))
    np.testing.assert_allclose(got.numpy(), lin.numpy(), **TOL)


@pytest.mark.parametrize("P", [8, 32])
@pytest.mark.parametrize("lengths", LENGTHS)
@pytest.mark.parametrize("kind", ["identity", "group_perm", "partial"])
def test_int8_paged_plain_matches_interpreted_pallas_kernel(P, lengths,
                                                            kind):
    rng, q, k, v = _inputs(40 + P + len(kind) + lengths[0])
    rows = _rows(kind, rng)
    lens = np.asarray(lengths, np.int32)
    pk, pv, pmap = _pages(rng, k, v, P, lengths)
    (kq, ks), (vq, vs) = _quantized(pk), _quantized(pv)
    ks, vs = ks[..., None], vs[..., None]          # (n_pages, KvE, P, 1)
    want = np.asarray(jax_decode_i8_paged(
        *map(jnp.asarray, (q, kq, ks, vq, vs, lens, pmap, rows)),
        interpret=True))
    got = decode_attention_int8_paged_resident(
        *map(torch.from_numpy, (q, kq, ks, vq, vs, lens, pmap, rows)))
    assert got.shape == (B, len(rows), DH)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("variant", ["int8", "paged", "int8_paged"])
def test_new_bshd_wrappers_match_jax_twins(variant):
    """Model-layout caches (B,T,KvE,dh) and page stores (n_pages,P,KvE,dh)
    with (..., KvE) scales, read through transposed views, and the
    inv_rows scatter."""
    P = 16
    rng, q, k, v = _inputs(7)
    lens = np.asarray([5, 64, 65], np.int32)
    rows = _rows("group_perm", rng)
    inv = np.argsort(rows).astype(np.int32)
    if "paged" in variant:
        k, v, pmap = _pages(rng, k, v, P, lens)    # (n_pages, KvE, P, dh)
    model = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))
    args = [q[:, None]]
    if "int8" in variant:
        for x in (k, v):
            qq, sc = _quantized(x)
            args += [model(qq), model(sc)]
    else:
        args += [model(k), model(v)]
    args.append(lens)
    if "paged" in variant:
        args.append(pmap)
    args.append(rows)
    fn = {"int8": "decode_attention_int8_resident_bshd",
          "paged": "decode_attention_paged_bshd",
          "int8_paged": "decode_attention_int8_paged_bshd"}[variant]
    want = np.asarray(getattr(jops, fn)(*map(jnp.asarray, args),
                                        inv_rows=jnp.asarray(inv)))
    got = getattr(ops, fn)(*map(torch.from_numpy, args),
                           inv_rows=torch.from_numpy(inv))
    assert got.shape == (B, 1, H, DH)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_q8_equals_jitted_reference_bit_for_bit():
    """The port's ``_q8`` against the reference's under ``jax.jit`` (how
    the reference engine runs it) on 102400 (token, head) rows — enough
    to hit the rows where a literal ``/ 127`` would round the scale 1 ulp
    off — plus rows of zeros and ties at half-integers."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 200, 8, 128)).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # the 1e-8 floor
    x[0, 0, 1, :4] = [127.0, 0.5, 1.5, -2.5]          # round half to even
    want_q, want_s = _quantized(x)
    got_q, got_s = _q8(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_q.numpy(), want_q)


def test_new_wrappers_reject_what_the_kernels_do_not_take():
    rng, q, k, v = _inputs(8)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    lens = torch.full((B,), 4, dtype=torch.int32)
    rows = torch.arange(H, dtype=torch.int32)
    kq, ks = _q8(kt)
    with pytest.raises(ValueError, match="scales"):
        decode_attention_int8_resident(qt, kq, ks[..., :8], kq, ks, lens,
                                       rows)
    pmap = torch.zeros((B, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="page_map"):
        decode_attention_paged_resident(qt, kt, vt, lens, pmap[:2], rows)
    with pytest.raises(ValueError, match="scales"):
        decode_attention_int8_paged_resident(qt, kq, ks, kq, ks, lens, pmap,
                                             rows)
    with pytest.raises(ValueError, match="is on"):
        decode_attention_paged_resident(qt, kt, vt, lens,
                                        pmap.to("meta"), rows)


@pytest.mark.parametrize("B,KvE_,extent,sms", [
    (8, 8, 1024, 132),      # the dense path: 8 splits of 128, 512 blocks
    (8, 2, 8264, 132),      # the glm4 path: 33 splits of 256, 528 blocks
    (8, 8, 1024, 114),      # another card's SM count
    (4, 2, 80, 132),        # small shapes: fewer positions than the card
    (6, 2, 1100, 132),
    (1, 1, 100000, 132),
    (8, 8, 1, 132),
    (8, 8, 16 * 64, 132),   # the paged path: 16 pages of 64
    (8, 8, 171 * 6, 132),   # pages of 6: an extent of no whole split
])
def test_decode_split_fills_the_card(B, KvE_, extent, sms):
    """The split body's sequence split: a positive multiple of its
    alignment, NS splits covering the extent with no empty one, and a
    grid within a factor of 2 of 4 blocks per SM where the extent holds
    that many aligned pieces."""
    from repro_torch.kernels.decode_attention import (_DECODE_SPLIT_ALIGN,
                                                      _decode_split)
    split = _decode_split(B, KvE_, extent, sms)
    n = -(-extent // split)
    assert split > 0 and split % _DECODE_SPLIT_ALIGN == 0
    assert n * split >= extent > (n - 1) * split
    grid = B * KvE_ * n
    pieces = B * KvE_ * -(-extent // _DECODE_SPLIT_ALIGN)
    assert grid >= min(2 * sms, pieces)
    assert grid <= max(8 * sms, B * KvE_)
    if (B, KvE_, extent, sms) == (8, 8, 1024, 132):
        assert (split, n, grid) == (128, 8, 512)
    if (B, KvE_, extent, sms) == (8, 2, 8264, 132):
        assert (split, n, grid) == (256, 33, 528)
    if (B, KvE_, extent, sms) == (8, 8, 171 * 6, 132):
        assert (split, n, grid) == (128, 9, 576)


_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "int64_t": ctypes.c_int64}


@pytest.mark.parametrize("entry", [
    "decode_attention_resident_launch",
    "decode_attention_int8_resident_launch",
    "decode_attention_paged_resident_launch",
    "decode_attention_int8_paged_resident_launch",
    "decode_attention_ring_resident_launch",
    "rwkv6_launch",
])
def test_signatures_match_the_cuda_entry_points(entry):
    """Each entry point's ctypes argument types (its wrapper module's
    ``_SIGNATURES``) against its ``extern "C"`` declaration in the module's
    source (``csrc/decode_attention.cu``, ``csrc/rwkv6.cu``), parsed from
    the source: a count or an order that differs would pass a pointer as
    an int.  Each source declares exactly its wrapped entry points."""
    from repro_torch.kernels import decode_attention, rwkv6
    mod = next(m for m in (decode_attention, rwkv6) if entry in m._SIGNATURES)
    src = (Path(mod.__file__).with_name("csrc")
           / f"{mod.__name__.rsplit('.', 1)[-1]}.cu").read_text()
    assert set(re.findall(r'extern "C" int (\w+)\(', src)) \
        == set(mod._SIGNATURES)
    params = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                       re.S).group(1)
    types = [p.strip().rsplit(None, 1)[0].replace("const ", "")
             .replace(" ", "") for p in params.split(",")]
    assert [_C_TYPES[t] for t in types] == mod._SIGNATURES[entry]
