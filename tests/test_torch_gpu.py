"""The CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (``nvcc``): they are
marked ``gpu`` and skip elsewhere.  On the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have.)

Tolerances: float32 ``atol=rtol=1e-5`` (summation order only); bfloat16
``atol=2e-2`` after upcasting (the output rounds to bf16); the flash, ring
and split-body decode kernels also per output row (``FLASH_ROW_REL``,
``RING_ROW_REL``, ``DECODE_ROW_REL``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_resident, decode_attention_resident_plain)

pytestmark = pytest.mark.gpu

TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=2e-2, rtol=0.0)}
# The flash and ring kernels are also bounded per output row, as the chip
# smoke test bounds them: ||out_r - want_r|| / ||want_r|| (over many keys
# an output is as small as TOLS's bf16 atol).
FLASH_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RING_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DECODE_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _row_rel_err(out, want) -> float:
    diff = (out.float() - want.float()).norm(dim=-1)
    norm = want.float().norm(dim=-1)
    return torch.where(norm > 0, diff / norm, diff).max().item()


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


def _q8(x):
    from repro_torch.models.layers import _q8 as q8
    return q8(x)


def _paged_inputs(cuda, dtype, dh, P, seed):
    """A random (n_pages, KvE, P, dh) pool, as a view of the model's
    (n_pages, P, KvE, dh) store, and a page map that is a random
    permutation of the pool with -1 -> 0 entries past each row's pages."""
    B, H, KvE, n_log = 4, 8, 2, 5
    T = n_log * P
    rng = np.random.default_rng(seed)
    n_pages = B * n_log + 2
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    store = torch.from_numpy(rng.standard_normal((2, n_pages, P, KvE, dh),
                                                 np.float32))
    q, store = q.to(cuda, dtype), store.to(cuda, dtype)
    lengths = [0, 1, T, T + 1]
    live = [-(-min(n, T) // P) for n in lengths]
    perm = rng.permutation(n_pages)[:B * n_log].reshape(B, n_log)
    pmap = np.where(np.arange(n_log)[None] < np.asarray(live)[:, None],
                    perm, 0)
    return (q, store[0].transpose(1, 2), store[1].transpose(1, 2),
            torch.tensor(lengths, dtype=torch.int32, device=cuda),
            torch.as_tensor(pmap, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 64, 128])
def test_int8_kernel_matches_plain_version(cuda, dtype, dh):
    from repro_torch.kernels.decode_attention import (
        decode_attention_int8_resident, decode_attention_int8_resident_plain)
    B, H, KvE, T = 4, 8, 2, 80
    rng = np.random.default_rng(dh + 1)
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, B, T, KvE, dh),
                                                 np.float32)).to(cuda)
    (kq, ks), (vq, vs) = _q8(cache[0]), _q8(cache[1])
    args = (q.to(cuda, dtype), kq.transpose(1, 2), ks.transpose(1, 2),
            vq.transpose(1, 2), vs.transpose(1, 2),
            torch.tensor([0, 1, T, T + 1], dtype=torch.int32, device=cuda),
            torch.tensor([5, 4, 0, 2, 3], dtype=torch.int32, device=cuda))
    before = decode_attention_int8_resident.launches
    out = decode_attention_int8_resident(*args)
    torch.cuda.synchronize()
    assert decode_attention_int8_resident.launches == before + 1
    want = decode_attention_int8_resident_plain(*args)
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    assert not out[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [64, 8, 6])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_kernels_match_plain_versions(cuda, dtype, P, quant):
    """Page sizes 64, 8 and 6 (6: tiles and splits cross pages)."""
    from repro_torch.kernels import decode_attention as da
    q, k, v, lengths, pmap = _paged_inputs(cuda, dtype, 64, P, P)
    rows = torch.tensor([1, 0, 7, 6, 2], dtype=torch.int32, device=cuda)
    if quant:
        (kq, ks), (vq, vs) = _q8(k.float()), _q8(v.float())
        args = (q, kq, ks[..., None], vq, vs[..., None], lengths, pmap, rows)
        kern = da.decode_attention_int8_paged_resident
        plain = da.decode_attention_int8_paged_resident_plain
    else:
        args = (q, k, v, lengths, pmap, rows)
        kern = da.decode_attention_paged_resident
        plain = da.decode_attention_paged_resident_plain
    before = kern.launches
    out = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    torch.testing.assert_close(out.float(), plain(*args).float(),
                               **TOLS[dtype])
    assert not out[0].any()


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_kernel_gives_nan_for_a_page_id_out_of_range(cuda, quant):
    """A page id the kernel would read outside [0, n_pages) gives NaN for
    that batch row and no fault; other rows, and ids past a row's length,
    are unaffected."""
    from repro_torch.kernels import decode_attention as da
    q, k, v, lengths, pmap = _paged_inputs(cuda, torch.float32, 32, 8, 3)
    n_pages = k.shape[0]
    pmap[2, 1] = n_pages                      # read by row 2 (length T)
    pmap[3, 0] = -5                           # read by row 3
    pmap[1, 3] = 10 ** 6                      # past row 1's length 1
    rows = torch.arange(8, dtype=torch.int32, device=cuda)
    if quant:
        (kq, ks), (vq, vs) = _q8(k), _q8(v)
        out = da.decode_attention_int8_paged_resident(
            q, kq, ks[..., None], vq, vs[..., None], lengths, pmap, rows)
    else:
        out = da.decode_attention_paged_resident(q, k, v, lengths, pmap,
                                                 rows)
    torch.cuda.synchronize()
    assert torch.isnan(out[2]).all() and torch.isnan(out[3]).all()
    assert torch.isfinite(out[:2]).all()


# ------------------------------------------- the split body (linear, int8,
# paged, int8-paged): one block per (sequence split, KV head, batch row), a
# merge
def _splits(q, n_kv, extent):
    from repro_torch.kernels import decode_attention as da
    split = da._decode_split(q.shape[0], n_kv, extent,
                             da._sm_count(q.device))
    return split, -(-extent // split)


def _split_check(kern, plain, args, *, kv_rows=None, keep=None):
    """One launch, held to TOLS and DECODE_ROW_REL per (b, resident row)
    over the entries ``keep`` (default all); returns the output."""
    before = kern.launches
    out = kern(*args, kv_rows) if kv_rows is not None else kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    if keep is None:
        want, got = plain(*args), out
    else:
        sub = list(args[:-1]) + [args[-1][keep]]
        want = plain(*sub, kv_rows[keep]) if kv_rows is not None \
            else plain(*sub)
        got = out[:, keep]
    dtype = args[0].dtype
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])
    assert _row_rel_err(got, want) <= DECODE_ROW_REL[dtype]
    assert torch.isfinite(got).all()
    return out


def _resident_split_args(cuda, dtype, *, H, KvE, dh, T=1100, B=6, seed=0,
                         quant=False):
    """q and a (B, T, KvE, dh) cache seen transposed (``quant``: int8
    values and their (B, T, KvE) scales, as k, k_sc, v, v_sc), with
    lengths 0, 1, split - 1, split, split + 1 and T for the wrapper's
    split."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, B, T, KvE, dh),
                                                 np.float32)).to(cuda)
    q = q.to(cuda, dtype)
    split, n_splits = _splits(q, KvE, T)
    assert n_splits > 2
    lengths = torch.tensor([0, 1, split - 1, split, split + 1, T][:B],
                           dtype=torch.int32, device=cuda)
    if quant:
        (kq, ks), (vq, vs) = _q8(cache[0]), _q8(cache[1])
        kv = (kq.transpose(1, 2), ks.transpose(1, 2), vq.transpose(1, 2),
              vs.transpose(1, 2))
    else:
        kv = (cache[0].to(dtype).transpose(1, 2),
              cache[1].to(dtype).transpose(1, 2))
    return (q,) + kv + (lengths,), rng


def _check_rows_case(kern, plain, args, rng, H, G, case):
    """Rows for ``case`` (every row permuted across KV heads; a partial set
    in which KV head 0 has no row; an out-of-range ``rows`` and
    ``kv_rows`` entry giving NaN for that entry only), held to the plain
    version; a row of length 0 returns zeros."""
    cuda = args[0].device
    rows = rng.permutation(H)
    if case == "partial":
        rows = rng.permutation([r for r in range(H) if r >= G])[:G + 3]
    rows = torch.as_tensor(rows, dtype=torch.int32, device=cuda)
    if case != "nan_rows":
        out = _split_check(kern, plain, args + (rows,))
    else:
        kv_rows = rows // G
        rows[3], kv_rows[5] = H, -1
        keep = [r for r in range(H) if r not in (3, 5)]
        out = _split_check(kern, plain, args + (rows,), kv_rows=kv_rows,
                           keep=keep)
        assert torch.isnan(out[:, 3]).all() and torch.isnan(out[:, 5]).all()
        out = out[:, keep]
    assert not out[0].any()                  # length 0 returns zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 4, 16])
@pytest.mark.parametrize("case", ["permuted", "partial", "nan_rows"])
def test_resident_kernel_splits(cuda, dtype, dh, G, case):
    """T 1100 over several splits, lengths on the split's edges (0, 1,
    split - 1, split, split + 1, T), 1 (MHA), 4 and 16 q heads a KV head:
    every row
    permuted across KV heads; a partial set in which KV head 0 has no row;
    an out-of-range ``rows`` and ``kv_rows`` entry giving NaN for that
    entry only."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_resident as kern,
        decode_attention_resident_plain as plain)
    H = 32
    args, rng = _resident_split_args(cuda, dtype, H=H, KvE=H // G, dh=dh,
                                     seed=dh + G)
    _check_rows_case(kern, plain, args, rng, H, G, case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_int8_kernel_splits(cuda, dtype, dh, G):
    """int8 K/V with scales, T 1100 over several splits, lengths on the
    split's edges, 1, 4 and 16 q heads a KV head, rows permuted across KV
    heads."""
    from repro_torch.kernels import decode_attention as da
    H = 32
    args, rng = _resident_split_args(cuda, dtype, H=H, KvE=H // G, dh=dh,
                                     seed=dh + G + 1, quant=True)
    _check_rows_case(da.decode_attention_int8_resident,
                     da.decode_attention_int8_resident_plain, args, rng, H,
                     G, "permuted")


def _paged_split_args(cuda, dtype, dh, P, *, quant=True, B=6, H=16, KvE=4,
                      seed=0):
    """q and value pages (n_pages, KvE, P, dh) as views of the model's
    (n_pages, P, KvE, dh) store (a scrambled pool two pages larger than the
    rows need) — ``quant``: int8 value pages and scale pages (n_pages, KvE,
    P, 1) from (n_pages, P, KvE) stores, as k, k_sc, v, v_sc — lengths on
    the wrapper's split edges, and the page map (B, np) with 0 past each
    row's live pages."""
    rng = np.random.default_rng(seed)
    n_log = -(-1100 // P)
    cap, n_pages = n_log * P, B * n_log + 2
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    store = torch.from_numpy(rng.standard_normal((2, n_pages, P, KvE, dh),
                                                 np.float32)).to(cuda)
    q = q.to(cuda, dtype)
    if quant:
        (kq, ks), (vq, vs) = _q8(store[0]), _q8(store[1])
        kv = (kq.transpose(1, 2), ks.transpose(1, 2)[..., None],
              vq.transpose(1, 2), vs.transpose(1, 2)[..., None])
    else:
        kv = (store[0].to(dtype).transpose(1, 2),
              store[1].to(dtype).transpose(1, 2))
    split, n_splits = _splits(q, KvE, cap)
    assert n_splits > 2
    lengths = [0, 1, split - 1, split, split + 1, cap][:B]
    live = [-(-n // P) for n in lengths]
    perm = rng.permutation(n_pages)[:B * n_log].reshape(B, n_log)
    pmap = np.where(np.arange(n_log)[None] < np.asarray(live)[:, None],
                    perm, 0)
    return (q,) + kv + (
        torch.tensor(lengths, dtype=torch.int32, device=cuda),
        torch.as_tensor(pmap, dtype=torch.int32, device=cuda)), rng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 4, 16])
@pytest.mark.parametrize("P", [64, 8, 6])
@pytest.mark.parametrize("case", ["permuted", "partial", "nan_rows"])
def test_paged_kernel_splits(cuda, dtype, dh, G, P, case):
    """Pages of 64, 8 and 6 positions (6: tiles and splits cross pages)
    over several splits, lengths on the split's edges, 1, 4 and 16 q heads
    a KV head, rows as in :func:`test_resident_kernel_splits`."""
    from repro_torch.kernels import decode_attention as da
    H = 32
    args, rng = _paged_split_args(cuda, dtype, dh, P, quant=False, H=H,
                                  KvE=H // G, seed=dh + G + P)
    _check_rows_case(da.decode_attention_paged_resident,
                     da.decode_attention_paged_resident_plain, args, rng, H,
                     G, case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("P", [64, 8, 6])
def test_int8_paged_kernel_splits(cuda, dtype, dh, P):
    """Pages of 64, 8 and 6 positions (6: tiles and splits cross pages)
    over several splits, lengths on the split's edges, rows permuted
    across KV heads."""
    from repro_torch.kernels import decode_attention as da
    args, rng = _paged_split_args(cuda, dtype, dh, P, seed=dh + P)
    rows = torch.as_tensor(rng.permutation(16), dtype=torch.int32,
                           device=cuda)
    out = _split_check(da.decode_attention_int8_paged_resident,
                       da.decode_attention_int8_paged_resident_plain,
                       args + (rows,))
    assert not out[0].any()


def _nan_in_the_last_split(kern, plain, args, rng):
    """A bad page id that only the last split of row 5 (length np * P)
    reads makes that row NaN, and only that row; a bad id past row 2's
    length changes nothing."""
    q, kq, pmap = args[0], args[1], args[-1]
    rows = torch.as_tensor(rng.permutation(16), dtype=torch.int32,
                           device=q.device)
    clean = _split_check(kern, plain, args + (rows,))
    n_log, P = pmap.shape[1], kq.shape[2]
    split, n_splits = _splits(q, kq.shape[1], n_log * P)
    assert (n_log - 1) * P >= (n_splits - 1) * split   # in the last split
    dirty = pmap.clone()
    dirty[5, n_log - 1] = kq.shape[0]                 # read by the last
    dirty[2, n_log - 2] = 10 ** 6                     # past row 2's length
    out = kern(*args[:-1], dirty, rows)
    torch.cuda.synchronize()
    assert torch.isnan(out[5]).all()
    assert torch.equal(out[:5], clean[:5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_int8_paged_kernel_nan_in_the_last_split(cuda, dtype, dh):
    """See :func:`_nan_in_the_last_split`: int8 pages of 8."""
    from repro_torch.kernels import decode_attention as da
    args, rng = _paged_split_args(cuda, dtype, dh, 8, seed=dh)
    _nan_in_the_last_split(da.decode_attention_int8_paged_resident,
                           da.decode_attention_int8_paged_resident_plain,
                           args, rng)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_paged_kernel_nan_in_the_last_split(cuda, dtype, dh):
    """See :func:`_nan_in_the_last_split`: pages of 8 in q's dtype."""
    from repro_torch.kernels import decode_attention as da
    args, rng = _paged_split_args(cuda, dtype, dh, 8, quant=False,
                                  seed=dh + 1)
    _nan_in_the_last_split(da.decode_attention_paged_resident,
                           da.decode_attention_paged_resident_plain, args,
                           rng)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["resident", "int8", "paged", "int8_paged"])
def test_split_kernels_refuse_unaligned_values(cuda, kind, dtype, dh):
    """Values whose position stride (dh + 1 values) is no whole number of
    16-byte pieces cannot be staged by cp.async: the wrapper raises before
    launch."""
    from repro_torch.kernels import decode_attention as da
    rng = np.random.default_rng(dh)
    B, H, KvE, P, n_log = 2, 8, 2, 8, 4
    paged = "paged" in kind
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32)).to(
        cuda, dtype)
    wide = torch.from_numpy(rng.standard_normal(
        (2, B * n_log if paged else B, P if paged else P * n_log, KvE,
         dh + 1), np.float32)).to(cuda)
    rows = torch.arange(H, dtype=torch.int32, device=cuda)
    lengths = torch.tensor([5, 17], dtype=torch.int32, device=cuda)
    pmap = torch.arange(B * n_log, dtype=torch.int32,
                        device=cuda).reshape(B, n_log)
    if "int8" in kind:
        (kq, ks), (vq, vs) = _q8(wide[0]), _q8(wide[1])
        ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
        if paged:
            ks, vs = ks[..., None], vs[..., None]
        kv = (kq[..., :dh].transpose(1, 2), ks, vq[..., :dh].transpose(1, 2),
              vs)
    else:
        kv = tuple(t[..., :dh].transpose(1, 2) for t in wide.to(dtype))
    kern = getattr(da, {"resident": "decode_attention_resident",
                        "int8": "decode_attention_int8_resident",
                        "paged": "decode_attention_paged_resident",
                        "int8_paged": "decode_attention_int8_paged_resident"
                        }[kind])
    args = (q,) + kv + (lengths,) + ((pmap,) if paged else ()) + (rows,)
    before = kern.launches
    with pytest.raises(ValueError, match="16-byte"):
        kern(*args)
    assert kern.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_paged_kernels_equal_linear_ones_bit_for_bit(cuda, dtype, quant, G):
    """A dense cache, and a pool that holds the same rows in scrambled
    pages with np * P == T: the paged kernel's output equals the linear
    kernel's bit for bit (fp and int8), since both run the split body with
    one split and only addressing differs."""
    from repro_torch.kernels import decode_attention as da
    B, H, dh, P, n_log = 6, 32, 128, 64, 18
    KvE, T = H // G, n_log * P
    rng = np.random.default_rng(G + quant)
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32)).to(
        cuda, dtype)
    cache = torch.from_numpy(rng.standard_normal((2, B, T, KvE, dh),
                                                 np.float32)).to(cuda)
    split, n_splits = _splits(q, KvE, T)
    assert n_splits > 2
    lengths = torch.tensor([0, 1, split - 1, split + 1, T, T + 1],
                           dtype=torch.int32, device=cuda)
    rows = torch.as_tensor(rng.permutation(H), dtype=torch.int32,
                           device=cuda)
    perm = torch.as_tensor(rng.permutation(B * n_log).reshape(B, n_log),
                           device=cuda)

    def pool(x):                       # (B, T, ...) -> scrambled pages
        out = torch.empty((B * n_log, P) + x.shape[2:], dtype=x.dtype,
                          device=cuda)
        out[perm.reshape(-1)] = x.reshape((B * n_log, P) + x.shape[2:])
        return out

    pmap = perm.to(torch.int32)
    if quant:
        (kq, ks), (vq, vs) = _q8(cache[0]), _q8(cache[1])
        linear = da.decode_attention_int8_resident(
            q, kq.transpose(1, 2), ks.transpose(1, 2), vq.transpose(1, 2),
            vs.transpose(1, 2), lengths, rows)
        paged = da.decode_attention_int8_paged_resident(
            q, pool(kq).transpose(1, 2), pool(ks).transpose(1, 2)[..., None],
            pool(vq).transpose(1, 2), pool(vs).transpose(1, 2)[..., None],
            lengths, pmap, rows)
    else:
        k, v = cache[0].to(dtype), cache[1].to(dtype)
        linear = da.decode_attention_resident(
            q, k.transpose(1, 2), v.transpose(1, 2), lengths, rows)
        paged = da.decode_attention_paged_resident(
            q, pool(k).transpose(1, 2), pool(v).transpose(1, 2), lengths,
            pmap, rows)
    torch.cuda.synchronize()
    assert torch.isfinite(linear).all() and linear[1:].any()
    assert torch.equal(paged, linear)


def ring_slot_pos(window, n_written):
    """The slot positions of a ring after positions 0 .. n_written - 1
    were written, slot ``t % window`` taking position t; never-written
    slots hold -2**30."""
    pos = np.full(window, -2 ** 30, np.int64)
    for t in range(max(0, n_written - window), n_written):
        pos[t % window] = t
    return pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["wrapped", "partly_filled", "permuted"])
def test_ring_kernel_matches_plain_version(cuda, dtype, case):
    """A ring wrapped past its window (lengths in (W, 3W]), a partly filled
    one with empty slots (lengths 0 .. W, a row with no valid slot returns
    zeros), and resident rows under a group permutation."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_ring_resident, decode_attention_ring_resident_plain)
    B, H, KvE, W, dh = 4, 8, 2, 96, 128
    rng = np.random.default_rng(len(case))
    if case == "partly_filled":
        n = 53
        lengths = [0, 1, 37, n]
    else:
        n = 2 * W + 17
        lengths = [n, n - 1, n - 40, W + 3]
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    ring = torch.from_numpy(rng.standard_normal((2, B, W, KvE, dh),
                                                np.float32))
    q, ring = q.to(cuda, dtype), ring.to(cuda, dtype)
    if case == "permuted":
        groups = rng.permutation(KvE)
        rows = np.concatenate([g * 4 + rng.permutation(4) for g in groups])
    else:
        rows = np.arange(H)
    args = (q, ring[0].transpose(1, 2), ring[1].transpose(1, 2),
            torch.tensor(lengths, dtype=torch.int32, device=cuda),
            torch.as_tensor(ring_slot_pos(W, n), dtype=torch.int32,
                            device=cuda),
            torch.as_tensor(rows, dtype=torch.int32, device=cuda))
    before = decode_attention_ring_resident.launches
    out = decode_attention_ring_resident(*args, window=W)
    torch.cuda.synchronize()
    assert decode_attention_ring_resident.launches == before + 1
    want = decode_attention_ring_resident_plain(*args, window=W)
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    assert torch.isfinite(out).all()
    if case == "partly_filled":
        assert not out[0].any()              # no valid slot: zeros


def _ring_args(cuda, dtype, *, B=4, H=16, KvE=4, W=600, dh=128, n=200,
               lengths=(200, 1, 0, 150), rows=None, seed=0):
    """Ring-kernel arguments: a random (B, W, KvE, dh) ring as the model
    keeps it, seen transposed, after positions 0 .. n - 1 were written."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    ring = torch.from_numpy(rng.standard_normal((2, B, W, KvE, dh),
                                                np.float32))
    q, ring = q.to(cuda, dtype), ring.to(cuda, dtype)
    rows = np.arange(H) if rows is None else np.asarray(rows)
    return (q, ring[0].transpose(1, 2), ring[1].transpose(1, 2),
            torch.tensor(lengths, dtype=torch.int32, device=cuda),
            torch.as_tensor(ring_slot_pos(W, n), dtype=torch.int32,
                            device=cuda),
            torch.as_tensor(rows, dtype=torch.int32, device=cuda))


def _ring_check(args, W):
    from repro_torch.kernels.decode_attention import (
        decode_attention_ring_resident, decode_attention_ring_resident_plain)
    before = decode_attention_ring_resident.launches
    out = decode_attention_ring_resident(*args, window=W)
    torch.cuda.synchronize()
    assert decode_attention_ring_resident.launches == before + 1
    want = decode_attention_ring_resident_plain(*args, window=W)
    torch.testing.assert_close(out.float(), want.float(),
                               **TOLS[args[0].dtype])
    assert _row_rel_err(out, want) <= RING_ROW_REL[args[0].dtype]
    assert torch.isfinite(out).all()
    return out


def _ring_splits(args, W):
    from repro_torch.kernels import decode_attention as da
    q, k = args[0], args[1]
    split = da._ring_split(q.shape[0], k.shape[1], W, da._sm_count(q.device))
    return split, -(-W // split)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["partial_permuted", "empty_split",
                                  "empty_row", "ragged_split",
                                  "two_passes"])
def test_ring_kernel_edges(cuda, dtype, case):
    """The split-window ring kernel's edges: resident rows that are a
    partial, permuted subset whose KV heads are not adjacent (heads 3, 0,
    1, 3, 0 of 4); window splits that hold no valid slot (200 of 600 slots
    written); a batch row with no valid slot (length 0: zeros); a window
    that is not a multiple of the split (600 slots); 8 q rows per KV head,
    scored in two passes of 4."""
    W = 600
    kw = {"partial_permuted": dict(rows=[13, 2, 7, 14, 1], n=2 * W + 37,
                                   lengths=(2 * W + 37, 2 * W, W + 1, W)),
          "empty_split": dict(n=200, lengths=(200, 120, 30, 199)),
          "empty_row": dict(n=W + 90, lengths=(0, W + 90, 5, W + 1)),
          "ragged_split": dict(n=3 * W, lengths=(3 * W, 3 * W - 1,
                                                 2 * W + 1, 3 * W - 7)),
          "two_passes": dict(KvE=2, n=2 * W + 5,
                             rows=[15, 3, 8, 0, 9, 1, 14, 2, 7, 4, 13, 5,
                                   10, 6, 12, 11],
                             lengths=(2 * W + 5, 2 * W, W + 2, 700)),
          }[case]
    args = _ring_args(cuda, dtype, seed=len(case), **kw)
    split, n_splits = _ring_splits(args, W)
    assert n_splits > 1 and W % split          # several, the last ragged
    out = _ring_check(args, W)
    if case == "empty_row":
        assert not out[0].any()
    if case == "empty_split":                  # slots 200.. never written
        assert split * (n_splits - 1) >= 200


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_ring_kernel_head_widths(cuda, dtype, dh):
    """Every head width the wrapper takes, on a wrapped ring of 600 slots
    in several splits and a group-permuted row order."""
    W = 600
    rows = np.concatenate([g * 4 + np.array([2, 0, 3, 1])
                           for g in (1, 3, 0, 2)])
    args = _ring_args(cuda, dtype, dh=dh, n=2 * W + 11, rows=rows,
                      lengths=(2 * W + 11, 2 * W, W + 5, 2 * W - 300),
                      seed=dh)
    _ring_check(args, W)


def test_ring_kernel_gives_nan_for_rows_out_of_range(cuda):
    """An out-of-range ``rows`` or ``kv_rows`` entry gives NaN for that
    entry and is never dereferenced; the other entries are unaffected."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_ring_resident, decode_attention_ring_resident_plain)
    W = 600
    q, k, v, lens, pos, rows = _ring_args(cuda, torch.float32, n=2 * W,
                                          lengths=(2 * W,) * 4)
    kv_rows = rows // 4
    rows[3], kv_rows[5] = 16, -1
    out = decode_attention_ring_resident(q, k, v, lens, pos, rows, kv_rows,
                                         window=W)
    torch.cuda.synchronize()
    assert torch.isnan(out[:, 3]).all() and torch.isnan(out[:, 5]).all()
    keep = [r for r in range(16) if r not in (3, 5)]
    want = decode_attention_ring_resident_plain(q, k, v, lens, pos,
                                                rows[keep], kv_rows[keep],
                                                window=W)
    torch.testing.assert_close(out[:, keep], want, **TOLS[torch.float32])


# ------------------------------------------------------------------ rwkv6
# Kernel and plain version both compute in float32 from the same inputs
# (bfloat16 r/k/v are upcast exactly), so one tolerance holds for both
# dtypes: summation order only, over up to 200 dependent steps.
RWKV_TOL = dict(atol=1e-4, rtol=1e-4)


def extreme_decays(rng, smooth):
    """Decays as the rwkv6 path meets them (exact 0.0, below 1e-30, exact
    1.0, above 0.999), mixed per element into ``smooth`` (B, S, H, dh):
    0.0 (3 %), 10^-30 to 10^-44 (3 %; below 1e-38 a float32 denormal),
    1.0 (20 %), 1 - 10^-3 x (0, 1] (40 %), else ``smooth``."""
    f = torch.from_numpy(rng.random(tuple(smooth.shape))).to(smooth.device)
    w = torch.where(f < 0.66, 1.0 - 1e-3 * (0.66 - f) / 0.4, smooth.double())
    w = torch.where(f < 0.26, 1.0, w)
    w = torch.where(f < 0.06, torch.pow(10.0, -30.0 - 14.0 * (f - 0.03)
                                        / 0.03), w)
    return torch.where(f < 0.03, 0.0, w).float()


def rwkv_inputs(cuda, dtype, B, H, S, dh, seed, u_dtype=None,
                decays="smooth"):
    """r/k/v (B, H, S, dh) in ``dtype`` and w float32 in (0.45, 0.95)
    (``decays="extreme"``: with the path's extremes mixed in), as
    transposed views of (B, S, H, dh) activations (the model's layout);
    u (H, dh) and a nonzero float32 starting state."""
    rng = np.random.default_rng(seed)
    act = torch.from_numpy(0.5 * rng.standard_normal((4, B, S, H, dh))
                           ).float().to(cuda)
    r, k, v = (act[i].to(dtype).transpose(1, 2) for i in range(3))
    w = 0.45 + 0.5 * torch.sigmoid(act[3])
    if decays == "extreme":
        w = extreme_decays(rng, w)
    w = w.transpose(1, 2)
    u = torch.from_numpy(0.5 * rng.standard_normal((H, dh))).to(
        cuda, u_dtype or dtype)
    s0 = torch.from_numpy(0.1 * rng.standard_normal((B, H, dh, dh))).to(
        cuda, torch.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 37, 200])
def test_rwkv6_kernel_matches_plain_version(cuda, dtype, dh, S):
    """Decode (S = 1), a ragged last chunk (37) and several chunks (200)."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked, rwkv6_chunked_plain
    args = rwkv_inputs(cuda, dtype, 3, 4, S, dh, seed=S + dh)
    before = rwkv6_chunked.launches
    y, s = rwkv6_chunked(*args)
    torch.cuda.synchronize()
    assert rwkv6_chunked.launches == before + 1
    want_y, want_s = rwkv6_chunked_plain(*args)
    assert y.shape == (3, 4, S, dh) and y.dtype == torch.float32
    torch.testing.assert_close(y, want_y, **RWKV_TOL)
    torch.testing.assert_close(s, want_s, **RWKV_TOL)


def test_rwkv6_kernel_chains_in_place(cuda):
    """Two calls writing the state over their input equal one call; a
    bfloat16 u with float32 r/k/v is read as float32."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked, rwkv6_chunked_plain
    r, k, v, w, u, s0 = rwkv_inputs(cuda, torch.float32, 2, 3, 80, 64,
                                    seed=7, u_dtype=torch.bfloat16)
    y_full, s_full = rwkv6_chunked_plain(r, k, v, w, u, s0)
    state = s0.clone()
    ys = [rwkv6_chunked(r[:, :, a:b], k[:, :, a:b], v[:, :, a:b],
                        w[:, :, a:b], u, state, out_state=state)[0]
          for a, b in ((0, 33), (33, 80))]
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(ys, dim=2), y_full, **RWKV_TOL)
    torch.testing.assert_close(state, s_full, **RWKV_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 200])
def test_rwkv6_kernel_at_extreme_decays(cuda, dtype, dh, S):
    """Both bodies at the path's extreme decays (exact 0.0, below 1e-30,
    exact 1.0, above 0.999): the per-step body (S < 16), the chunked body
    at one chunk, a chunk and one, and many chunks; held to the plain
    version and, for the chunked body, to the plain chunked form.  Every
    output is finite."""
    from repro_torch.kernels.rwkv6 import (rwkv6_chunked,
                                           rwkv6_chunked_plain,
                                           rwkv6_chunkwise_plain)
    args = rwkv_inputs(cuda, dtype, 3, 4, S, dh, seed=3 * S + dh,
                       decays="extreme")
    before = rwkv6_chunked.launches
    y, s = rwkv6_chunked(*args)
    torch.cuda.synchronize()
    assert rwkv6_chunked.launches == before + 1
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    want_y, want_s = rwkv6_chunked_plain(*args)
    torch.testing.assert_close(y, want_y, **RWKV_TOL)
    torch.testing.assert_close(s, want_s, **RWKV_TOL)
    if S >= 16:
        form_y, form_s = rwkv6_chunkwise_plain(*args)
        torch.testing.assert_close(y, form_y, **RWKV_TOL)
        torch.testing.assert_close(s, form_s, **RWKV_TOL)


@pytest.mark.parametrize("split", [1, 16, 33])
def test_rwkv6_kernel_chains_in_place_at_extreme_decays(cuda, split):
    """Two bf16 calls writing the state over their input, across the two
    bodies (split 1: per-step then chunked; 16 and 33: chunked twice, the
    second ragged), equal one plain call at the extreme decays."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked, rwkv6_chunked_plain
    r, k, v, w, u, s0 = rwkv_inputs(cuda, torch.bfloat16, 2, 3, 90, 64,
                                    seed=split, decays="extreme")
    y_full, s_full = rwkv6_chunked_plain(r, k, v, w, u, s0)
    state = s0.clone()
    ys = [rwkv6_chunked(r[:, :, a:b], k[:, :, a:b], v[:, :, a:b],
                        w[:, :, a:b], u, state, out_state=state)[0]
          for a, b in ((0, split), (split, 90))]
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(ys, dim=2), y_full, **RWKV_TOL)
    torch.testing.assert_close(state, s_full, **RWKV_TOL)


def test_rwkv6_chunked_body_rejects_unaligned_inputs(cuda):
    """The chunked body stages 16-byte pieces: an r/k/v/w whose base or
    strides are not 16-byte multiples raises for S >= 16 (the per-step
    body reads them one by one and takes them)."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    r, k, v, w, u, s0 = rwkv_inputs(cuda, torch.float32, 1, 2, 17, 16,
                                    seed=4)
    odd = torch.zeros(1 + r.numel(), device=cuda)[1:].view(r.shape)
    odd.copy_(r)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_chunked(odd, k, v, w, u, s0)
    y, _ = rwkv6_chunked(odd[:, :, :15], k[:, :, :15], v[:, :, :15],
                         w[:, :, :15], u, s0)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()


def test_rwkv6_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    r, k, v, w, u, s0 = rwkv_inputs(cuda, torch.float32, 1, 2, 4, 16, seed=1)
    with pytest.raises(ValueError, match="float32 w"):
        rwkv6_chunked(r, k, v, w.to(torch.bfloat16), u, s0)
    with pytest.raises(ValueError, match="r/k/v"):
        rwkv6_chunked(r.half(), k.half(), v.half(), w, u, s0)
    big = rwkv_inputs(cuda, torch.float32, 1, 1, 2, 128, seed=2)
    with pytest.raises(ValueError, match="dh"):
        rwkv6_chunked(*big)


# ------------------------------------------------------------------ flash
def flash_inputs(cuda, dtype, *, B=2, H=8, KvE=2, Sq=200, Skv=200, dh=64,
                 seed=0):
    """q (B, H, Sq, dh) and k, v (B, KvE, Skv, dh) as transposed views of
    the model's (B, S, H, dh) activations and (B, T, KvE, dh) caches."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, dh), np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, B, Skv, KvE, dh),
                                              np.float32))
    q, kv = q.to(cuda, dtype), kv.to(cuda, dtype)
    return q.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)


def _flash_check(cuda, dtype, causal, window, **shape):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = flash_inputs(cuda, dtype, **shape)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    assert _row_rel_err(out, want) <= FLASH_ROW_REL[dtype]
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("mask", ["causal", "window", "full"])
def test_flash_kernel_matches_plain_version(cuda, dtype, dh, mask):
    """Causal, windowed (48) and non-causal attention over 200 positions
    at every head width: a ragged last tile for both bodies (bf16 wgmma:
    128-row q and K/V tiles, 32-, 64- and 128-byte swizzles; f32: 64-row
    q tiles, 32-row K/V tiles)."""
    _flash_check(cuda, dtype, mask != "full", 48 if mask == "window" else 0,
                 dh=dh, seed=dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["short_q_causal", "short_q_full",
                                  "ragged_1000", "glm_groups",
                                  "musicgen_mha", "qwen_mha"])
def test_flash_kernel_shapes(cuda, dtype, case):
    """Sq < Skv (70 over 300; the causal mask aligned at the top left), a
    ragged S = 1000 under a window of 300, GLM-4's 16 query heads per KV
    group at dh 128, and MHA (one query head per KV head): musicgen-large's
    32 heads at dh 64 and qwen1.5-32b's 40 at dh 128."""
    shape, causal, window = {
        "short_q_causal": (dict(Sq=70, Skv=300), True, 0),
        "short_q_full": (dict(Sq=70, Skv=300), False, 0),
        "ragged_1000": (dict(B=1, H=4, KvE=1, Sq=1000, Skv=1000), True,
                        300),
        "glm_groups": (dict(B=1, H=32, KvE=2, Sq=333, Skv=333, dh=128),
                       True, 0),
        "musicgen_mha": (dict(B=2, H=32, KvE=32, Sq=333, Skv=333, dh=64),
                         True, 0),
        "qwen_mha": (dict(B=1, H=40, KvE=40, Sq=333, Skv=333, dh=128),
                     True, 0),
    }[case]
    _flash_check(cuda, dtype, causal, window, seed=len(case), **shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_refuses_unaligned_kv(cuda, dtype):
    """K/V whose position stride (129 values) is not a multiple of 8 cannot
    be staged in 16-byte copies: the wrapper refuses them before launch."""
    from repro_torch.kernels.flash_attention import flash_attention
    q, _, _ = flash_inputs(cuda, dtype, B=1, H=8, KvE=2, Sq=150, Skv=150,
                           dh=128, seed=5)
    rng = np.random.default_rng(6)
    wide = torch.from_numpy(rng.standard_normal((2, 1, 150, 2, 129),
                                                np.float32)).to(cuda, dtype)
    k, v = (t[..., :128].transpose(1, 2) for t in wide)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(q, k, v, causal=True, window=40)
    assert flash_attention.launches == before


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = flash_inputs(cuda, torch.float32, Sq=8, Skv=8, dh=48)
    with pytest.raises(ValueError, match="dh"):
        flash_attention(q, k, v)
    q, k, v = flash_inputs(cuda, torch.float32, Sq=8, Skv=8, dh=16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention(q, k.to(torch.bfloat16), v)


def _strided_flash_inputs(cuda, dtype, *, B, H, KvE, Sq, Skv, dh, seed):
    """q as a head slice of a wider (B, Sq, H + 4, dh) activation, k and v
    as position slices (from 8) of (B, Skv + 24, KvE, dh) caches: strided,
    transposed views with offset bases."""
    rng = np.random.default_rng(seed)
    wide = torch.from_numpy(rng.standard_normal((B, Sq, H + 4, dh),
                                                np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, B, Skv + 24, KvE, dh),
                                                 np.float32))
    wide, cache = wide.to(cuda, dtype), cache.to(cuda, dtype)
    return (wide[:, :, 2:H + 2].transpose(1, 2),
            cache[0, :, 8:8 + Skv].transpose(1, 2),
            cache[1, :, 8:8 + Skv].transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["glm_groups_b2", "ragged_q_tile",
                                  "skv_over_sq", "skv_over_sq_full",
                                  "window_crosses_tile", "strided_dh64",
                                  "strided_dh128"])
def test_flash_kernel_edges(cuda, dtype, case):
    """The 128-row wgmma body's edges: GLM-4's 16 query heads per KV group
    with B = 2; Sq not a multiple of 128 (700); Skv > Sq (130 over 520,
    causal and not); a window edge crossing 128-row tiles (100 over 512);
    dh 64 and 128 on strided, transposed views with offset bases."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    shape, causal, window = {
        "glm_groups_b2": (dict(B=2, H=32, KvE=2, Sq=300, Skv=300, dh=128),
                          True, 0),
        "ragged_q_tile": (dict(B=1, H=8, KvE=2, Sq=700, Skv=700, dh=128),
                          True, 0),
        "skv_over_sq": (dict(B=2, H=8, KvE=2, Sq=130, Skv=520, dh=128),
                        True, 0),
        "skv_over_sq_full": (dict(B=2, H=8, KvE=2, Sq=130, Skv=520, dh=64),
                             False, 0),
        "window_crosses_tile": (dict(B=1, H=8, KvE=8, Sq=512, Skv=512,
                                     dh=128), True, 100),
        "strided_dh64": (dict(B=2, H=8, KvE=2, Sq=333, Skv=333, dh=64),
                         True, 0),
        "strided_dh128": (dict(B=2, H=8, KvE=2, Sq=333, Skv=333, dh=128),
                          True, 150),
    }[case]
    if case.startswith("strided"):
        q, k, v = _strided_flash_inputs(cuda, dtype, seed=len(case), **shape)
        assert not q.is_contiguous() and k.storage_offset() > 0
    else:
        q, k, v = flash_inputs(cuda, dtype, seed=len(case), **shape)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    assert _row_rel_err(out, want) <= FLASH_ROW_REL[dtype]
    assert torch.isfinite(out).all()


# ------------------------------------------------------ the pipelined engine
def _pipelined_run(cfg, params, prompts, **kw):
    """Serve ``prompts`` (8 new tokens each) on the card, a 500x straggler
    at step 6 on the busiest device when ``pipeline_k`` > 1; returns the
    streams and the engine."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, n_slots=4, max_seq=64, seed=0,
                        net=DeviceNetwork.sample(4, seed=1), device="cuda",
                        params=params, **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    while True:
        if eng.pipeline_k > 1 and eng.decode_steps == 6:
            dev = int(eng.controller.head_counts().argmax())
            eng.net.inject_straggler(dev, slowdown=500.0)
        if not eng.step():
            break
    return {r.rid: r.out_tokens for r in eng.finished}, eng


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pipelined_engine_streams_through_the_kernels(cuda, paged):
    """``pipeline_k=2`` with the bottleneck search and the kernels, in
    float32: streams equal the sequential plain engine's with no
    migration, migrations were applied to both groups, the decode kernel
    launched once a layer for each group decode (B = 2 rows), and every
    interval fell on a multiple of λ·K."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.api import build_model
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_head=32,
        d_ff=512, vocab_size=1024, dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1024, size=n) for n in (4, 9, 6, 11, 7, 5)]
    seq, _ = _pipelined_run(cfg, params, prompts, lam=10 ** 9)
    kernel = da.decode_attention_paged_resident if paged \
        else da.decode_attention_resident
    before = kernel.launches
    kw = dict(paged=True, page_size=8) if paged else {}
    pipe, eng = _pipelined_run(cfg, params, prompts, lam=3, pipeline_k=2,
                               search="bottleneck", use_kernel=True, **kw)
    assert pipe == seq and len(pipe) == len(prompts)
    assert kernel.launches - before == len(eng.step_times) * cfg.n_layers
    assert all(int(st["pos"].shape[0]) == 2 for st in eng.states)
    assert all(e["step"] % 6 == 0 for e in eng.migration_log)
    assert any(e["applied"] and e["n_migrations"] and e["reason"] is None
               for e in eng.migration_log)
    if paged:
        for alloc in eng.allocators:
            alloc.check_invariants()
            assert alloc.live_pages == 0


# ------------------------------------------------- churn and the async drain
def _churn_engine(cfg, params, **kw):
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(cfg, n_slots=4, max_seq=64, seed=0,
                         net=DeviceNetwork.sample(4, seed=1), device="cuda",
                         params=params, **kw)


def _small_f32():
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_head=32,
        d_ff=512, vocab_size=1024, dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 1024, size=n) for n in (4, 9, 6, 11, 7, 5)]
    return cfg, params, prompts


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fail_rejoin_through_the_kernels_equals_plain(cuda, paged):
    """float32 on the card: the busiest device fails at step 5 and rejoins
    at step 12 on a kernel-path engine (λ 4); its streams equal the plain
    engine's with no churn, the replay's decode steps went through the
    kernel (launches == (decodes + replay steps) x layers), and the pool
    drains."""
    from repro_torch.kernels import decode_attention as da
    cfg, params, prompts = _small_f32()
    kw = dict(paged=True, page_size=8) if paged else {}
    plain = _churn_engine(cfg, params, lam=10 ** 9, **kw)
    for p in prompts:
        plain.submit(p, max_new_tokens=8)
    plain.run()
    kernel = da.decode_attention_paged_resident if paged \
        else da.decode_attention_resident
    eng = _churn_engine(cfg, params, lam=4, use_kernel=True, **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    before = kernel.launches
    dead = None
    while True:
        if eng.decode_steps == 5:
            dead = int(eng.controller.head_counts().argmax())
            assert eng._active()
            eng.fail_device(dead)
        if eng.decode_steps == 12:
            eng.rejoin_device(dead)
        if not eng.step():
            break
    assert {r.rid: r.out_tokens for r in eng.finished} == \
        {r.rid: r.out_tokens for r in plain.finished}
    rec = eng.recovery_log
    assert [r["event"] for r in rec] == ["fail", "rejoin"]
    assert rec[0]["replay_steps"] > 0 and rec[0]["tokens_lost"] == 0
    assert kernel.launches - before == \
        (len(eng.step_times) + rec[0]["replay_steps"]) * cfg.n_layers
    if paged:
        eng.allocator.check_invariants()
        assert eng.allocator.live_pages == 0


def test_async_drain_on_the_card_leaves_no_live_page(cuda):
    """The async runtime over a paged kernel-path engine on the card: the
    streams equal ``drive_virtual``'s and the drain frees every page."""
    import asyncio

    from repro_torch.serving.async_runtime import AsyncServingEngine
    from repro_torch.serving.workload import drive_virtual, make_workload
    cfg, params, _ = _small_f32()
    reqs = make_workload("poisson", rate=0.3, horizon=30.0, seed=5,
                         vocab=cfg.vocab_size)
    kw = dict(lam=10 ** 9, use_kernel=True, paged=True, page_size=8,
              kv_pages=12)
    sync = drive_virtual(_churn_engine(cfg, params, **kw), reqs)
    eng = _churn_engine(cfg, params, **kw)

    async def go():
        async with AsyncServingEngine(eng, queue_limit=len(reqs) + 1) as rt:
            handles = [rt.submit(r.prompt, max_new_tokens=r.max_new_tokens)
                       for r in reqs]
            await rt.drain()
        return {h.rid: h.tokens for h in handles}

    assert asyncio.run(go()) == sync["streams"]
    assert sync["n_finished"] == len(reqs)
    eng.allocator.check_invariants()
    assert eng.allocator.live_pages == 0 and eng.allocator.reserved_pages == 0
