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
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
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
@pytest.mark.parametrize("dh", [16, 64, 80, 128])
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
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
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


# the VLM's cross-attention decode: q (B, 32, 128) over one cross layer's
# image K/V, a view into the (G, B, I, KvE, dh) stack, I = 1601 (no
# multiple of a split or a tile), rows of a full image, a 448x448 tile
# (1025 rows) or none
VLM_IMG = 1601


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [(VLM_IMG, 1025, 0, VLM_IMG),
                                     (0, 0, 0, 0), (1, 1600, 64, 1537)],
                         ids=["mixed", "imageless", "edges"])
def test_kernel_over_stacked_image_kv(cuda, dtype, lengths):
    rng = np.random.default_rng(len(lengths) + lengths[-1])
    B, H, KvE, dh = len(lengths), 32, 8, 128
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    img_kv = torch.from_numpy(rng.standard_normal(
        (2, 2, B, VLM_IMG, KvE, dh), np.float32))
    q, img_kv = q.to(cuda, dtype), img_kv.to(cuda, dtype)
    k, v = img_kv[0, 1].transpose(1, 2), img_kv[1, 1].transpose(1, 2)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    out = _split_check(decode_attention_resident,
                       decode_attention_resident_plain,
                       (q, k, v, lens, torch.arange(H, dtype=torch.int32,
                                                    device=cuda)))
    for b, n in enumerate(lengths):
        if n == 0:
            assert not out[b].any()          # length 0 returns zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_block_kernel_equals_plain(cuda, dtype):
    """The model's gated cross-attention at the VLM's head shapes: S == 1
    through the kernel (lengths from the mask, imageless rows patched to
    the mean of V) against the plain masked path, over image K/V of
    1601 rows."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config("llama-3.2-vision-11b").with_overrides(
        d_model=512, dtype=str(dtype).split(".")[-1])
    hd = L.head_dims(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = L.init_attention(gen, cfg, hd, (), dtype, cuda, cross=True)
    p["gate"].fill_(0.7)
    B = 4
    x = torch.randn((B, 1, 512), generator=gen, device=cuda).to(dtype)
    img = torch.randn((B, VLM_IMG, 512), generator=gen,
                      device=cuda).to(dtype)
    mask = torch.zeros((B, VLM_IMG), dtype=torch.bool, device=cuda)
    for b, n in enumerate((VLM_IMG, 1025, 0, 7)):
        mask[b, :n] = True
    plain, kv = L.cross_attention_block(cfg, p, hd, x, kv_embeds=img,
                                        kv_mask=mask)
    got, _ = L.cross_attention_block(cfg, p, hd, x, kv_cache=kv,
                                     kv_mask=mask, use_kernel=True)
    torch.cuda.synchronize()
    tol = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}[dtype]
    torch.testing.assert_close(got.float(), plain.float(), **tol)
    assert _row_rel_err(got[:, 0], plain[:, 0]) <= DECODE_ROW_REL[dtype]
    assert got[2].abs().max() > 0            # the patched imageless row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
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
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
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
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
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
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
def test_int8_paged_kernel_nan_in_the_last_split(cuda, dtype, dh):
    """See :func:`_nan_in_the_last_split`: int8 pages of 8."""
    from repro_torch.kernels import decode_attention as da
    args, rng = _paged_split_args(cuda, dtype, dh, 8, seed=dh)
    _nan_in_the_last_split(da.decode_attention_int8_paged_resident,
                           da.decode_attention_int8_paged_resident_plain,
                           args, rng)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
def test_paged_kernel_nan_in_the_last_split(cuda, dtype, dh):
    """See :func:`_nan_in_the_last_split`: pages of 8 in q's dtype."""
    from repro_torch.kernels import decode_attention as da
    args, rng = _paged_split_args(cuda, dtype, dh, 8, quant=False,
                                  seed=dh + 1)
    _nan_in_the_last_split(da.decode_attention_paged_resident,
                           da.decode_attention_paged_resident_plain, args,
                           rng)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
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
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
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
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("mask", ["causal", "window", "full"])
def test_flash_kernel_matches_plain_version(cuda, dtype, dh, mask):
    """Causal, windowed (48) and non-causal attention over 200 positions
    at every head width: a ragged last tile for both bodies (bf16 wgmma:
    128-row q and K/V tiles, 32-, 64- and 128-byte swizzles, dh 80 in
    five 32-byte panels; f32: 64-row q tiles, 32-row K/V tiles)."""
    _flash_check(cuda, dtype, mask != "full", 48 if mask == "window" else 0,
                 dh=dh, seed=dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["short_q_causal", "short_q_full",
                                  "ragged_1000", "glm_groups",
                                  "musicgen_mha", "qwen_mha", "zamba2_mha",
                                  "zamba2_short_q", "zamba2_short_q_full"])
def test_flash_kernel_shapes(cuda, dtype, case):
    """Sq < Skv (70 over 300; the causal mask aligned at the top left), a
    ragged S = 1000 under a window of 300, GLM-4's 16 query heads per KV
    group at dh 128, and MHA (one query head per KV head): musicgen-large's
    32 heads at dh 64, qwen1.5-32b's 40 at dh 128 and zamba2's 32 at dh 80
    (also with Sq < Skv, causal and not)."""
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
        "zamba2_mha": (dict(B=2, H=32, KvE=32, Sq=333, Skv=333, dh=80),
                       True, 0),
        "zamba2_short_q": (dict(B=1, H=8, KvE=8, Sq=70, Skv=300, dh=80),
                           True, 0),
        "zamba2_short_q_full": (dict(B=1, H=8, KvE=8, Sq=70, Skv=300,
                                     dh=80), False, 0),
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


# ------------------------------------------------------- head width 80
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_width_80_reaches_the_cuda_library(cuda, dtype, monkeypatch):
    """At dh 80 on the card every decode entry point and flash launch
    their CUDA kernels: with each plain version replaced by one that
    raises, the wrappers still return (and count a launch), and the
    results match the real plain versions."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import _q8 as q8
    plain = {n: getattr(da, n + "_plain") for n in (
        "decode_attention_resident", "decode_attention_int8_resident",
        "decode_attention_paged_resident",
        "decode_attention_int8_paged_resident",
        "decode_attention_ring_resident")}
    plain["flash_attention"] = fa.flash_attention_plain

    def refuse(*a, **k):
        raise AssertionError("a plain version ran for CUDA tensors")

    for name in plain:
        if name == "flash_attention":
            monkeypatch.setattr(fa, "flash_attention_plain", refuse)
        else:
            monkeypatch.setattr(da, name + "_plain", refuse)
    rng = np.random.default_rng(80)
    B, H, T, P, dh = 2, 4, 96, 16, 80
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32)).to(
        cuda, dtype)
    cache = torch.from_numpy(rng.standard_normal((2, B, T, H, dh),
                                                 np.float32)).to(cuda)
    lens = torch.tensor([T, 37], dtype=torch.int32, device=cuda)
    rows = torch.arange(H, dtype=torch.int32, device=cuda)
    kc, vc = cache[0].to(dtype), cache[1].to(dtype)
    (kq, ks), (vq, vs) = q8(cache[0]), q8(cache[1])
    pmap = torch.arange(B * (T // P), dtype=torch.int32,
                        device=cuda).reshape(B, T // P)

    def pages(t):   # (B, T, ...) -> a (B * T / P, P, ...) store, seen
        return t.reshape((B * (T // P), P) + t.shape[2:])

    cases = {
        "decode_attention_resident": (q, kc.transpose(1, 2),
                                      vc.transpose(1, 2), lens, rows),
        "decode_attention_int8_resident": (
            q, kq.transpose(1, 2), ks.transpose(1, 2), vq.transpose(1, 2),
            vs.transpose(1, 2), lens, rows),
        "decode_attention_paged_resident": (
            q, pages(kc).transpose(1, 2), pages(vc).transpose(1, 2), lens,
            pmap, rows),
        "decode_attention_int8_paged_resident": (
            q, pages(kq).transpose(1, 2), pages(ks).transpose(1, 2)[..., None],
            pages(vq).transpose(1, 2), pages(vs).transpose(1, 2)[..., None],
            lens, pmap, rows),
        "decode_attention_ring_resident": (
            q, kc.transpose(1, 2), vc.transpose(1, 2), lens,
            torch.arange(T, dtype=torch.int32, device=cuda), rows),
    }
    ring = {"window": T}
    qf, kf, vf = flash_inputs(cuda, dtype, B=1, H=4, KvE=4, Sq=150, Skv=150,
                              dh=dh, seed=8)
    outs = {}
    for name, args in cases.items():
        kern = getattr(da, name)
        before = kern.launches
        outs[name] = kern(*args, **(ring if "ring" in name else {}))
        assert kern.launches == before + 1, name
    before = fa.flash_attention.launches
    outs["flash_attention"] = fa.flash_attention(qf, kf, vf, causal=True)
    assert fa.flash_attention.launches == before + 1
    torch.cuda.synchronize()
    monkeypatch.undo()     # the int8 plain versions call the fp one
    cases["flash_attention"] = (qf, kf, vf)
    for name, args in cases.items():
        flash = name == "flash_attention"
        want = plain[name](*args, **({"causal": True} if flash else ring
                                     if "ring" in name else {}))
        torch.testing.assert_close(outs[name].float(), want.float(),
                                   **TOLS[dtype])
        bound = (FLASH_ROW_REL if flash else DECODE_ROW_REL)[dtype]
        assert _row_rel_err(outs[name], want) <= bound, name


# ------------------------------------------ identity rows and int8 weights
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dh", [64, 128])
def test_identity_row_wrappers_match_plain_versions(cuda, dtype, quant, dh):
    """``decode_attention`` and ``decode_attention_int8`` launch the split
    body over every q head, count the launch under their own name (not
    the resident entry point's) and give their plain versions' output."""
    from repro_torch.kernels import decode_attention as da
    B, H, KvE, T = 4, 8, 2, 80
    rng = np.random.default_rng(dh + quant)
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, B, T, KvE, dh),
                                                 np.float32)).to(cuda)
    lengths = torch.tensor([0, 1, T, T + 1], dtype=torch.int32, device=cuda)
    q = q.to(cuda, dtype)
    if quant:
        (kq, ks), (vq, vs) = _q8(cache[0]), _q8(cache[1])
        args = (q, kq.transpose(1, 2), ks.transpose(1, 2),
                vq.transpose(1, 2), vs.transpose(1, 2), lengths)
        kern, plain = da.decode_attention_int8, da.decode_attention_int8_plain
    else:
        cache = cache.to(dtype)
        args = (q, cache[0].transpose(1, 2), cache[1].transpose(1, 2),
                lengths)
        kern, plain = da.decode_attention, da.decode_attention_plain
    before = (kern.launches, da.decode_attention_resident.launches,
              da.decode_attention_int8_resident.launches)
    out = kern(*args)
    torch.cuda.synchronize()
    assert (kern.launches, da.decode_attention_resident.launches,
            da.decode_attention_int8_resident.launches) == (
        before[0] + 1,) + before[1:]
    want = plain(*args)
    assert out.shape == (B, H, dh)
    torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
    assert _row_rel_err(out, want) <= DECODE_ROW_REL[dtype]
    assert not out[0].any()


def test_decode_attention_bshd_runs_the_kernel(cuda):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 128),
                                             np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.standard_normal((2, 96, 2, 128),
                                                 np.float32)).to(cuda)
            for _ in range(2))
    lengths = torch.tensor([96, 17], dtype=torch.int32, device=cuda)
    before = da.decode_attention.launches
    out = ops.decode_attention_bshd(q, k, v, lengths)
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_plain(q[:, 0], k.transpose(1, 2),
                                     v.transpose(1, 2), lengths)[:, None]
    torch.testing.assert_close(out, want, **TOLS[torch.float32])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama3-8b"])
def test_int8_capacity_model_kernel_logits_match_plain(cuda, arch):
    """A small float32 model on int8 weights (``quantize_params``; mixtral
    with capacity dispatch at cf 1.25 and a ring of 64 slots): a
    lock-step prefill of 80 tokens (flash) and 4 teacher-forced decode
    steps (the ring or the resident kernel) give the plain path's logits
    within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.api import build_model
    from repro_torch.models.quantization import quantize_params
    over = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_head=64,
                d_ff=256, vocab_size=128, dtype="float32",
                param_dtype="float32")
    if arch == "mixtral-8x7b":
        over.update(n_experts=4, sliding_window=64)
    cfg = get_config(arch).with_overrides(**over)
    kw = dict(capacity_moe=True) if cfg.is_moe else {}
    models = [build_model(cfg, use_kernel=uk, device=cuda, **kw)
              for uk in (True, False)]
    params = quantize_params(models[0].init(
        torch.Generator(device=cuda).manual_seed(0)))
    assert params["layers"]["attn"]["wq"]["q8"].dtype == torch.int8
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 128, (2, 80))).to(cuda)
    ring = da.decode_attention_ring_resident
    kern = ring if cfg.is_moe else da.decode_attention_resident
    before = (kern.launches, flash_attention.launches)
    runs = []
    for m in models:
        state = m.init_decode_state(params, 2, 90)
        logits, state = m.prefill(params, state, tokens)
        seen = [logits]
        for t in range(4):
            nxt = runs[0][t].argmax(-1) if runs else logits.argmax(-1)
            logits, state = m.decode_step(params, state, nxt)
            seen.append(logits)
        runs.append(seen)
    assert (kern.launches, flash_attention.launches) == (
        before[0] + 4 * cfg.n_layers, before[1] + cfg.n_layers)
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------ autograd refusal
AUTOGRAD_ENTRY_POINTS = (
    "flash_attention", "decode_attention_resident",
    "decode_attention_int8_resident", "decode_attention_paged_resident",
    "decode_attention_int8_paged_resident", "decode_attention_ring_resident",
    "decode_attention", "decode_attention_int8", "rwkv6_chunked")


def autograd_case(entry: str, device):
    """(kernel entry point, args, kwargs) at a small shape on ``device``,
    its first floating input requiring grad."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    g = torch.Generator().manual_seed(0)
    B, H, KvE, T, dh = 2, 4, 2, 8, 16

    def rand(*shape):
        return torch.randn(shape, generator=g).to(device)

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=device)

    q = rand(B, H, dh).requires_grad_(True)
    lengths, rows = i32([3, T]), i32(list(range(H)))
    k8 = torch.randint(-127, 128, (B, KvE, T, dh), generator=g,
                       dtype=torch.int8).to(device)
    sc = rand(B, KvE, T).abs()
    pages8 = torch.randint(-127, 128, (3, KvE, 4, dh), generator=g,
                           dtype=torch.int8).to(device)
    page_sc = rand(3, KvE, 4, 1).abs()
    page_map = i32([[0, 1], [2, 0]])
    if entry == "flash_attention":
        return flash_attention, (rand(B, H, T, dh).requires_grad_(True),
                                 rand(B, KvE, T, dh), rand(B, KvE, T, dh)), {}
    if entry == "rwkv6_chunked":
        w = torch.rand((B, H, T, dh), generator=g).to(device)
        return rwkv6_chunked, (rand(B, H, T, dh).requires_grad_(True),
                               rand(B, H, T, dh), rand(B, H, T, dh), w,
                               rand(H, dh), rand(B, H, dh, dh)), {}
    fn = getattr(da, entry)
    args = {
        "decode_attention_resident": (q, rand(B, KvE, T, dh),
                                      rand(B, KvE, T, dh), lengths, rows),
        "decode_attention_int8_resident": (q, k8, sc, k8, sc, lengths, rows),
        "decode_attention_paged_resident": (
            q, rand(3, KvE, 4, dh), rand(3, KvE, 4, dh), lengths, page_map,
            rows),
        "decode_attention_int8_paged_resident": (
            q, pages8, page_sc, pages8, page_sc, lengths, page_map, rows),
        "decode_attention_ring_resident": (
            q, rand(B, KvE, T, dh), rand(B, KvE, T, dh), lengths,
            i32(list(range(T))), rows),
        "decode_attention": (q, rand(B, KvE, T, dh), rand(B, KvE, T, dh),
                             lengths),
        "decode_attention_int8": (q, k8, sc, k8, sc, lengths),
    }[entry]
    kw = {"window": T} if entry == "decode_attention_ring_resident" else {}
    return fn, args, kw


@pytest.mark.parametrize("entry", AUTOGRAD_ENTRY_POINTS)
def test_kernels_refuse_autograd(cuda, entry):
    """Every CUDA entry point raises when asked to be differentiated (the
    kernels have no backward), launching nothing; under ``no_grad`` the
    same inputs launch the kernel."""
    fn, args, kw = autograd_case(entry, cuda)
    before = fn.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args, **kw)
    assert fn.launches == before
    with torch.no_grad():
        fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One reduced float32 llama3-8b train step (``make_train_step``:
    autograd through the plain path, then AdamW) on the card against the
    same step on the CPU from the same weights: loss and updated params
    within 1e-4 of each leaf's scale."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=97, dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 97, (2, 17)).astype(np.int32))
    opt = AdamW(lr=1e-5)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev), params)
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        step = make_train_step(build_model(cfg, device=dev), opt)
        new_p, _, loss = step(p, opt.init(p), batch)
        out[dev.type] = (loss.item(), tree_leaves(new_p))
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max()


# ------------------------------------------- the tensor-parallel layout
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KvE", [(32, 16), (48, 48)],
                         ids=["llama_tp16_G2", "qwen_tp16_G1"])
@pytest.mark.parametrize("case", ["permuted", "partial"])
def test_resident_kernel_at_the_tp16_layouts(cuda, dtype, H, KvE, case):
    """The tp-16 decode shapes: llama3-8b's 32 q heads over 16 KV rows (8
    heads replicated twice, G 2) and qwen1.5-32b's 48 padded heads over
    48 (G 1), at dh 128 over several splits (B 4: at B 6 the wrapper
    splits 48 KV heads' 1100 positions only twice)."""
    args, rng = _resident_split_args(cuda, dtype, H=H, KvE=KvE, dh=128,
                                     B=4, seed=H + KvE)
    _check_rows_case(decode_attention_resident,
                     decode_attention_resident_plain, args, rng, H,
                     H // KvE, case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KvE", [(32, 16), (48, 48)],
                         ids=["llama_tp16", "qwen_tp16"])
def test_flash_kernel_at_the_tp16_layouts(cuda, dtype, H, KvE):
    _flash_check(cuda, dtype, True, 0, B=2, H=H, KvE=KvE, Sq=333, Skv=333,
                 dh=128, seed=H)


def _shard_decode_args(cuda, kind, dtype, rng, *, B=3, H=8, KvE=4, T=80,
                       dh=64, P=16):
    """Kernel-layout arguments of ``kind``'s decode kernel (without rows):
    K/V and scales are transposed views of model-layout caches, a paged
    store's pages scrambled."""
    from repro_torch.models.layers import _q8
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((B, T, KvE, dh),
                                                   np.float32))
              for _ in range(2))
    q, kc, vc = (t.to(cuda, dtype) for t in (q, kc, vc))
    lens = torch.tensor([0, T, 37][:B], dtype=torch.int32, device=cuda)
    pmap = None
    if "paged" in kind:
        n_log = T // P
        order = torch.as_tensor(rng.permutation(B * n_log), device=cuda)
        pools = []
        for c in (kc, vc):
            pool = torch.empty((B * n_log, P, KvE, dh), dtype=dtype,
                               device=cuda)
            pool[order] = c.reshape(B * n_log, P, KvE, dh)
            pools.append(pool)
        kc, vc = pools
        pmap = order.reshape(B, n_log).to(torch.int32)
    if "int8" in kind:
        (kc, ks), (vc, vs) = _q8(kc), _q8(vc)
        ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
        if "paged" in kind:
            ks, vs = ks[..., None], vs[..., None]
        kv = (kc.transpose(1, 2), ks, vc.transpose(1, 2), vs)
    else:
        kv = (kc.transpose(1, 2), vc.transpose(1, 2))
    return (q,) + kv + (lens,) + ((pmap,) if pmap is not None else ())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["resident", "int8_resident",
                                  "paged_resident", "int8_paged_resident"])
def test_decode_kernels_on_tp4_head_shards(cuda, kind, dtype):
    """The tp-4 layout's head shards (8 q heads over 4 KV rows: 2 over 1
    a shard): a placement's row maps through a non-identity applied
    layout, localized to each shard (``local_head_rows``), run through
    the kernel on the shard's q heads and KV rows; each shard's output
    equals its plain version and the shards put together equal the whole
    call, at the kernel tolerances (not bit for bit: the split follows
    KvE)."""
    from repro_torch.core.blocks import make_blocks
    from repro_torch.core.placement_bridge import head_row_maps
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.partitioning import local_head_rows
    kern = getattr(da, f"decode_attention_{kind}")
    plain = getattr(da, f"decode_attention_{kind}_plain")
    rng = np.random.default_rng(5)
    H, KvE, ranks = 8, 4, 4
    G, n, nk = H // KvE, H // ranks, KvE // ranks
    args = _shard_decode_args(cuda, kind, dtype, rng, H=H, KvE=KvE)
    layout = (rng.permutation(KvE)[:, None] * G + np.arange(G)).reshape(
        1, -1)
    rows, _ = head_row_maps(rng.integers(0, 4, H + 2), make_blocks(H), 4,
                            H, perms=layout)
    whole = kern(*args, torch.as_tensor(rows[0], device=cuda))
    whole = whole[:, torch.as_tensor(np.argsort(rows[0]), device=cuda)]
    parts = []
    for r in range(ranks):
        lr, li = local_head_rows(rows, r * n, n)
        sargs = (args[0][:, r * n:(r + 1) * n],) + tuple(
            a[:, r * nk:(r + 1) * nk] if a.dim() >= 3 else a
            for a in args[1:])
        lrows = torch.as_tensor(lr[0], device=cuda)
        out = kern(*sargs, lrows)
        want = plain(*sargs, lrows)
        torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
        assert _row_rel_err(out, want) <= DECODE_ROW_REL[dtype]
        parts.append(out[:, torch.as_tensor(li[0], device=cuda)])
    together = torch.cat(parts, dim=1)
    torch.testing.assert_close(together.float(), whole.float(),
                               **TOLS[dtype])
    assert _row_rel_err(together, whole) <= DECODE_ROW_REL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_kernel_on_tp4_head_shards(cuda, dtype):
    """The ring kernel on the tp-4 layout's head shards (16 q heads over 4
    KV rows: 4 over 1 a shard) of a wrapped ring of 600 slots: a
    placement's row maps through a non-identity applied layout, localized
    to each shard (``local_head_rows``); each shard's output equals its
    plain version and the shards put together equal the whole call, at
    the ring's tolerances.  The ring's slot positions are whole on every
    shard (replicated)."""
    from repro_torch.core.blocks import make_blocks
    from repro_torch.core.placement_bridge import head_row_maps
    from repro_torch.kernels.decode_attention import (
        decode_attention_ring_resident as kern,
        decode_attention_ring_resident_plain as plain)
    from repro_torch.models.partitioning import local_head_rows
    rng = np.random.default_rng(6)
    W, H, KvE, ranks = 600, 16, 4, 4
    G, n, nk = H // KvE, H // ranks, KvE // ranks
    args = _ring_args(cuda, dtype, H=H, KvE=KvE, n=2 * W + 37,
                      lengths=(2 * W + 37, 2 * W, W + 1, 700), seed=6)[:-1]
    layout = (rng.permutation(KvE)[:, None] * G + np.arange(G)).reshape(
        1, -1)
    rows, _ = head_row_maps(rng.integers(0, 4, H + 2), make_blocks(H), 4,
                            H, perms=layout)
    whole = kern(*args, torch.as_tensor(rows[0], device=cuda), window=W)
    whole = whole[:, torch.as_tensor(np.argsort(rows[0]), device=cuda)]
    parts = []
    for r in range(ranks):
        lr, li = local_head_rows(rows, r * n, n)
        sargs = (args[0][:, r * n:(r + 1) * n],) + tuple(
            a[:, r * nk:(r + 1) * nk] if a.dim() >= 3 else a
            for a in args[1:])
        lrows = torch.as_tensor(lr[0], device=cuda)
        out = kern(*sargs, lrows, window=W)
        want = plain(*sargs, lrows, window=W)
        torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
        assert _row_rel_err(out, want) <= RING_ROW_REL[dtype]
        parts.append(out[:, torch.as_tensor(li[0], device=cuda)])
    together = torch.cat(parts, dim=1)
    torch.testing.assert_close(together.float(), whole.float(),
                               **TOLS[dtype])
    assert _row_rel_err(together, whole) <= RING_ROW_REL[dtype]


def _tp_engine_streams(cuda, paged):
    from repro_torch.configs import get_config
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=97, dtype="float32", param_dtype="float32")
    eng = ServingEngine(cfg, n_slots=2, max_seq=64, lam=3, seed=0, tp=4,
                        net=DeviceNetwork.sample(4, seed=1), use_kernel=True,
                        paged=paged, page_size=8, device=cuda)
    assert eng.model.hd.rep == 2 and eng.model.hd.KvE == 4
    rng = np.random.default_rng(0)
    for i, n in enumerate((5, 11, 8, 14)):
        eng.submit(rng.integers(0, 97, size=n), max_new_tokens=10 + i % 2)
    while True:
        if eng.decode_steps == 4:
            eng.net.inject_straggler(
                int(eng.controller.head_counts().argmax()), slowdown=500.0)
        if not eng.step():
            break
    return {r.rid: r.out_tokens for r in eng.finished}, eng


def test_rep2_paged_engine_streams_equal_the_dense_engine(cuda):
    """tp 4 over 2 KV heads (rep 2): the paged store's head axis holds
    the 4 expanded rows; float32 greedy streams through the paged and
    resident kernels are equal, with migrations applied."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_paged_resident)
    before = decode_attention_paged_resident.launches
    paged, eng = _tp_engine_streams(cuda, True)
    assert decode_attention_paged_resident.launches > before
    dense, _ = _tp_engine_streams(cuda, False)
    assert paged == dense and len(paged) == 4
    assert any(e["applied"] and e["n_migrations"] for e in eng.migration_log)


def test_restore_onto_a_one_card_mesh(cuda, tmp_path):
    """``Checkpointer.restore(shardings=)`` on a (1, 1) ("data", "model")
    NCCL mesh: DTensor leaves on the card, their full tensors bit-equal
    to what was saved; ``save_async`` of the DTensor tree writes them
    back."""
    import socket
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.api import build_model
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=97)
    params = build_model(cfg, tp=16, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_debug_mesh(1, 1)
        ck = Checkpointer(tmp_path)
        ck.save(1, params)
        got = ck.restore(1, params,
                         shardings=param_shardings(params, cfg, mesh))
        for name in ("tok_embed", "lm_head"):
            assert got[name].device_mesh is mesh
            assert torch.equal(got[name].full_tensor(), params[name])
        for name, t in params["layers"]["attn"].items():
            assert torch.equal(got["layers"]["attn"][name].full_tensor(), t)
        # the DTensor tree saved back, on a thread: the mesh's ranks meet
        # in ``wait``
        ck.save_async(2, got)
        ck.wait()
        again = ck.restore(2, params)
        assert torch.equal(again["lm_head"], params["lm_head"])
    finally:
        dist.destroy_process_group()


# -------------------------- the recurrent families on tp-4 head shards
def _head_shard(t, r, n, dim=1):
    """Rank ``r``'s ``n`` heads of ``t`` as the rank's model holds them:
    its own contiguous tensor, a (B, H, S, dh) view of (B, S, H, dh)
    activations staying such a view."""
    part = t.narrow(dim, r * n, n)
    if dim == 1 and t.dim() == 4 and t.stride(1) < t.stride(2):
        return part.transpose(1, 2).contiguous().transpose(1, 2)
    return part.contiguous()


@pytest.mark.parametrize("decays", ["smooth", "extreme"])
@pytest.mark.parametrize("S", [1, 37, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_kernel_on_tp4_head_shards(cuda, dtype, S, decays):
    """The WKV6 kernel on the tp-4 head shards (8 heads of 64: 2 a shard),
    each shard's state written in place: each equals its plain version,
    and the four put together equal the whole call bit for bit (one block
    per (b, h): heads do not interact)."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked, rwkv6_chunked_plain
    args = rwkv_inputs(cuda, dtype, 3, 8, S, 64, seed=S + 3, decays=decays)
    y, s = rwkv6_chunked(*args)
    ys, states = [], []
    for r in range(4):
        sargs = tuple(_head_shard(t, r, 2, dim=0 if t.dim() == 2 else 1)
                      for t in args)
        want_y, want_s = rwkv6_chunked_plain(*sargs)
        out_y, out_s = rwkv6_chunked(*sargs, out_state=sargs[5])
        torch.cuda.synchronize()
        assert out_s.data_ptr() == sargs[5].data_ptr()
        torch.testing.assert_close(out_y, want_y, **RWKV_TOL)
        torch.testing.assert_close(out_s, want_s, **RWKV_TOL)
        ys.append(out_y)
        states.append(out_s)
    assert torch.equal(torch.cat(ys, dim=1), y)
    assert torch.equal(torch.cat(states, dim=1), s)


@pytest.mark.parametrize("kernel", ["flash", "resident"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_block_kernels_on_tp4_head_shards(cuda, dtype, kernel):
    """Zamba2's shared block at dh 80, G 1 (16 heads over 16 KV heads: 4
    a shard) on each rank's own heads and cache shard: flash at a causal
    prefill of 200, the resident kernel over identity rows at mixed
    lengths; each shard equals its plain version, the four put together
    the whole call, at the kernel tolerances."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    H, n = 16, 4
    if kernel == "flash":
        args = flash_inputs(cuda, dtype, B=2, H=H, KvE=H, Sq=200, Skv=200,
                            dh=80, seed=11)
        run = lambda a: flash_attention(*a, causal=True)  # noqa: E731
        plain = lambda a: flash_attention_plain(*a, causal=True)  # noqa
        cut = lambda a, r: tuple(_head_shard(t, r, n) for t in a)  # noqa
        limit = FLASH_ROW_REL[dtype]
    else:
        rng = np.random.default_rng(12)
        q = torch.from_numpy(rng.standard_normal((3, H, 80))).to(cuda, dtype)
        kc, vc = (torch.from_numpy(rng.standard_normal((3, 150, H, 80))).to(
            cuda, dtype) for _ in range(2))
        lens = torch.tensor([150, 1, 77], dtype=torch.int32, device=cuda)
        args = (q, kc.transpose(1, 2), vc.transpose(1, 2), lens)
        rows = torch.arange(H, dtype=torch.int32, device=cuda)
        local = rows[:n]
        run = lambda a: decode_attention_resident(  # noqa: E731
            *a, rows if a[0].shape[1] == H else local)
        plain = lambda a: decode_attention_resident_plain(*a, local)  # noqa
        cut = lambda a, r: tuple(_head_shard(t, r, n) for t in a[:3]) \
            + (a[3],)  # noqa: E731
        limit = DECODE_ROW_REL[dtype]
    whole = run(args)
    parts = []
    for r in range(4):
        sargs = cut(args, r)
        out = run(sargs)
        want = plain(sargs)
        torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
        assert _row_rel_err(out, want) <= limit
        parts.append(out)
    together = torch.cat(parts, dim=1)
    torch.testing.assert_close(together.float(), whole.float(),
                               **TOLS[dtype])
    assert _row_rel_err(together, whole) <= limit


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_recurrent_families_serve_on_a_one_card_mesh(cuda, arch):
    """``make_engine("auto", part=...)`` on a (1, 1) ("data", "model")
    NCCL mesh serves reduced f32 RWKV-6 and Zamba2 through their kernels
    (WKV6; flash and the resident kernel in the shared block): the wave
    engine, its state leaves DTensors, greedy streams equal to the
    unsharded engine's on the same weights."""
    import socket
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import is_dtensor, make_partitioner
    from repro_torch.serving.engine import WaveServingEngine, make_engine
    over = dict(d_model=64, d_ff=128, vocab_size=97, dtype="float32",
                param_dtype="float32", n_heads=4, d_head=16)
    over.update(n_layers=2) if arch == "rwkv6-7b" else over.update(
        n_layers=4, shared_attn_every=2, n_kv_heads=4, ssm_head_dim=16,
        ssm_state=8)
    cfg = get_config(arch).with_overrides(**over)
    params = build_model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    prompts = [np.random.default_rng(n).integers(0, 97, n)
               for n in (20, 20, 7)]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        streams = []
        for part in (None, make_partitioner(make_debug_mesh(1, 1))):
            eng = make_engine(cfg, part=part, use_kernel=True, device=cuda,
                              params=params, n_slots=2, max_seq=40, lam=3)
            assert isinstance(eng, WaveServingEngine)
            for p in prompts:
                eng.submit(p, 8)
            eng.run()
            streams.append({r.rid: r.out_tokens for r in eng.finished})
            if part is not None:
                state = eng.model.init_decode_state(eng.params, 2, 40)
                assert all(is_dtensor(t) for t in _tensors(
                    state["cache"]))
        assert len(streams[0]) == 3 and streams[0] == streams[1]
    finally:
        dist.destroy_process_group()


def _tensors(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vlm_cross_kernel_on_tp4_head_shards(cuda, dtype):
    """The VLM's cross-attention decode on the tp-4 head shards of
    llama-3.2-vision-11b's layout: 8 of 32 q heads over 2 of 8 KV rows a
    shard (G 4), each rank's image K/V shard its own tensor cut from one
    cross layer of the (G, B, I, KvE, dh) stack, I 1601, lengths 1601,
    1025 and 0 (an imageless row: the kernel's zeros, which the layer
    patches to the mean of V), identity rows of the shard's width as the
    sharded cross layer passes them.  Each shard equals its plain
    version, and the four put together equal the whole call, at the
    kernel tolerances."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_resident_plain)
    B, H, KvE, I, dh, ranks = 3, 32, 8, 1601, 128, 4
    n, nk = H // ranks, KvE // ranks
    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, dh), np.float32)).to(
        cuda, dtype)
    stack = torch.from_numpy(rng.standard_normal((2, 2, B, I, KvE, dh),
                                                 np.float32)).to(cuda, dtype)
    k, v = stack[0, 1], stack[1, 1]
    lens = torch.tensor([I, 1025, 0], dtype=torch.int32, device=cuda)
    whole = ops.decode_attention_resident_bshd(
        q, k, v, lens, torch.arange(H, dtype=torch.int32, device=cuda))
    rows = torch.arange(n, dtype=torch.int32, device=cuda)
    before = decode_attention_resident.launches
    parts = []
    for r in range(ranks):
        sq = q[:, :, r * n:(r + 1) * n].contiguous()
        sk, sv = (t[:, :, r * nk:(r + 1) * nk].contiguous() for t in (k, v))
        out = ops.decode_attention_resident_bshd(sq, sk, sv, lens, rows)
        want = decode_attention_resident_plain(
            sq[:, 0], sk.transpose(1, 2), sv.transpose(1, 2), lens, rows)
        torch.testing.assert_close(out[:, 0].float(), want.float(),
                                   **TOLS[dtype])
        assert _row_rel_err(out[:, 0], want) <= DECODE_ROW_REL[dtype]
        assert not out[2].any()              # length 0: zeros
        parts.append(out)
    assert decode_attention_resident.launches == before + ranks
    together = torch.cat(parts, dim=2)
    torch.testing.assert_close(together.float(), whole.float(),
                               **TOLS[dtype])
    assert _row_rel_err(together[:, 0], whole[:, 0]) <= DECODE_ROW_REL[dtype]


def test_vlm_int8_cache_step_through_the_int8_kernel(cuda):
    """A reduced float32 llama-3.2-vision (one supergroup, 8 q over 2 KV
    heads of 64) from an int8 cache (``kv_quant``): lock-step prefill and
    decode steps over images of all, half and none of an 8-row buffer,
    with the kernels — the int8 kernel once a self layer a step, the
    resident kernel once a cross layer — and without; every step's logits
    within the f32 stream bound (1e-3; the kernels read the same int8
    values and scales, summed in another order)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.api import build_model
    cfg = get_config("llama-3.2-vision-11b").with_overrides(
        n_layers=5, d_model=256, d_ff=512, vocab_size=97, n_heads=8,
        n_kv_heads=2, d_head=64, dtype="float32", param_dtype="float32",
        kv_quant=True)
    params = build_model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    params["cross_layers"]["attn"]["gate"].fill_(0.7)
    params["cross_layers"]["gate_ffn"].fill_(0.5)
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.standard_normal((3, 8, 256), np.float32)).to(
        cuda)
    mask = torch.zeros((3, 8), dtype=torch.bool, device=cuda)
    mask[0], mask[1, :4] = True, True
    toks = torch.from_numpy(rng.integers(0, 97, (3, 6))).to(cuda)
    runs = []
    for uk in (True, False):
        model = build_model(cfg, use_kernel=uk, device=cuda)
        state = model.init_decode_state(params, 3, 16, img_embeds=img,
                                        img_mask=mask)
        assert state["cache"]["k"].dtype == torch.int8
        before = (da.decode_attention_int8_resident.launches,
                  da.decode_attention_resident.launches)
        logits, state = model.prefill(params, state, toks)
        out = [logits]
        for i in range(3):
            logits, state = model.decode_step(params, state,
                                              toks[:, i].to(torch.int32))
            out.append(logits)
        runs.append(torch.stack(out))
        if uk:
            assert (da.decode_attention_int8_resident.launches - before[0],
                    da.decode_attention_resident.launches - before[1]) \
                == (3 * 4, 3 * 1)
    torch.testing.assert_close(runs[0], runs[1], atol=1e-3, rtol=0.0)


# ----------------------- paged caches and int8 weights on a mesh's ranks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_kernels_on_two_batch_ranks_pools(cuda, dtype, quant):
    """A paged store on a mesh whose batch axes hold two ranks: each rank
    holds half of a scrambled pool and its rows' page ids into that half
    (rank-local ids).  Each rank's call — its rows over its own pool —
    equals its plain version, and the two put together equal the
    whole-pool call with global ids, bit for bit (a row's splits follow
    the cache extent alone)."""
    from repro_torch.kernels import decode_attention as da
    q, k, v, lengths, pmap = _paged_inputs(cuda, dtype, 64, 8, 11)
    B, n_pages = q.shape[0], k.shape[0]
    rows = torch.tensor([1, 0, 7, 6, 2], dtype=torch.int32, device=cuda)
    kern = da.decode_attention_int8_paged_resident if quant \
        else da.decode_attention_paged_resident
    plain = da.decode_attention_int8_paged_resident_plain if quant \
        else da.decode_attention_paged_resident_plain
    if quant:
        (kq, ks), (vq, vs) = _q8(k.float()), _q8(v.float())
        pool = (kq, ks[..., None], vq, vs[..., None])
    else:
        pool = (k, v)
    # rank r owns rows [2r, 2r + 2) and the pages they read (a row's
    # entries past its length read page 0 of its pool), padded with
    # unread pages to half the pool, in a scrambled order
    pm = pmap.cpu().numpy()
    P = k.shape[2]
    live = [-(-min(int(n), pm.shape[1] * P) // P) for n in lengths.tolist()]
    read = [sorted({int(pm[b, i]) for b in (2 * r, 2 * r + 1)
                    for i in range(live[b])}) for r in range(2)]
    rng = np.random.default_rng(5)
    spare = [int(p) for p in rng.permutation(n_pages)
             if p not in read[0] + read[1]]
    half = n_pages // 2
    parts = []
    for r in range(2):
        others = spare[:half - len(read[r])]
        spare = spare[len(others):]
        ids = rng.permutation(np.asarray(read[r] + others))
        local_of = {int(g): i for i, g in enumerate(ids)}
        lmap = np.array([[local_of[int(pm[b, i])] if i < live[b] else 0
                          for i in range(pm.shape[1])]
                         for b in (2 * r, 2 * r + 1)])
        idx = torch.as_tensor(ids, dtype=torch.long, device=cuda)
        args = tuple(t.index_select(0, idx) for t in pool) + (
            lengths[2 * r:2 * r + 2],
            torch.as_tensor(lmap, dtype=torch.int32, device=cuda), rows)
        before = kern.launches
        out = kern(q[2 * r:2 * r + 2], *args)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        torch.testing.assert_close(out.float(),
                                   plain(q[2 * r:2 * r + 2], *args).float(),
                                   **TOLS[dtype])
        parts.append(out)
    whole = kern(q, *pool, lengths, pmap, rows)
    assert B == 4 and torch.equal(torch.cat(parts), whole)


def test_dequantize_weight_of_a_one_rank_dtensor_is_bit_equal(cuda):
    """``dequantize_weight`` of an int8 leaf placed on a (1, 1) NCCL mesh
    dequantizes the rank's shard into a DTensor of ``q8``'s placements,
    bit-equal to the plain leaf's, in bf16 and float32."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.partitioning import (Sharding, is_dtensor, local,
                                                 place, placements)
    from repro_torch.models.quantization import (dequantize_weight,
                                                 quantize_weight)
    w = torch.randn((2, 64, 8, 16), generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    leaf = quantize_weight(w, 3)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_debug_mesh(1, 1)
        placed = {
            "q8": place(leaf["q8"], Sharding(mesh, placements(
                mesh, (None, None, "model", None)))),
            "sc": place(leaf["sc"], Sharding(mesh, placements(
                mesh, (None, None))))}
        for dtype in (torch.bfloat16, torch.float32):
            got = dequantize_weight(placed, dtype)
            assert is_dtensor(got) and got.placements == \
                placed["q8"].placements
            assert torch.equal(local(got), dequantize_weight(leaf, dtype))
    finally:
        dist.destroy_process_group()
