"""Resident flash-decode: one query token per batch row against a long KV
cache, over only the q-head rows one device hosts — the paper's dominant
inference object, dispatched per (layer, device) from Algorithm 1's
placement.

Counterpart of the JAX package's ``kernels/decode_attention.py``: its five
Pallas TPU kernels over a linear, paged or sliding-window ring cache, in
the working dtype or int8 with per-(token, head) scales, are here
hand-written CUDA C++ for Hopper (``csrc/decode_attention.cu``, built by
``kernels.build``) behind five entry points.  The four linear and paged
ones run one split body (one block per sequence split, KV head and batch
row, each K/V row read once for all of its q heads, then a merge of the
splits; bf16 q over bf16 K/V on the tensor cores, f32 q and int8 K/V on
the CUDA cores), and the ring its own split-window kernel:

- ``decode_attention_resident``: K/V (B, KvE, T, dh);
- ``decode_attention_int8_resident``: int8 K/V (B, KvE, T, dh) with f32
  scales (B, KvE, T);
- ``decode_attention_paged_resident``: K/V pages (n_pages, KvE, P, dh)
  read through ``page_map`` (B, np);
- ``decode_attention_int8_paged_resident``: int8 K/V pages with f32
  scale pages (n_pages, KvE, P, 1);
- ``decode_attention_ring_resident``: a sliding-window ring K/V
  (B, KvE, W, dh) whose slot t holds absolute position ``slot_pos[t]``;

and ``decode_attention`` / ``decode_attention_int8``, the reference's
dense-grid wrappers: the first two over identity rows (``arange(H)``).

``decode_attention_resident`` and ``decode_attention_ring_resident`` also
serve a cache whose sequence (or ring slots) is sharded over devices (the
long-decode path, ``partitioning.SeqShard``): with ``return_lse=True`` they
return the float32 output and each row's log-sum-exp of its scores
(natural log; -1e30 where no position counts), the partials a merge
across the devices needs, and the ring takes a buffer of fewer slots than
its window (one device's share of the slots).

Each launches the kernel for CUDA tensors, counts the launch in its
``.launches``, and runs its ``*_plain`` version — the same function in
plain PyTorch — only for tensors on the CPU.  There is no fallback: a
CUDA tensor the kernel does not take (a dtype it lacks, a dh outside
``SUPPORTED_DH`` — 16, 32, 64, zamba2's 80 and 128 — values without
16-byte aligned bases and strides) raises ``ValueError``, and an input
autograd would record raises ``RuntimeError``: the kernels have no
backward (``kernels.refuse_autograd``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, refuse_autograd

SUPPORTED_DH = (16, 32, 64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain versions: the same functions in plain PyTorch
# ---------------------------------------------------------------------------


def _masked_decode_plain(q, k, v, valid, rows, kv_rows, return_lse=False):
    """A softmax over the gathered rows' K/V positions where ``valid``
    (B, T) holds, accumulated in float32.  ``return_lse``: (the float32
    output, the (B, R) log-sum-exp of the valid scores, -1e30 for a row
    with none)."""
    B, H, dh = q.shape
    KvE = k.shape[1]
    rows = rows.long()
    kv_rows = rows // (H // KvE) if kv_rows is None else kv_rows.long()
    qr = q.index_select(1, rows).float()                    # (B, R, dh)
    if k.shape[2] == 0:      # a device holding no position of the cache
        out = torch.zeros_like(qr)
        if not return_lse:
            return out.to(q.dtype)
        return out, torch.full(qr.shape[:2], -1e30, device=q.device)
    # One KV head at a time, as the kernel's blocks read the cache: its
    # float32 copy holds one head's (B, T, dh), never the whole cache or
    # the rows' gathered copy of it (``analysis.trace_audit``'s JXP001).
    # Each query row keeps the scores and the output of its own head.
    own = [(kv_rows == e)[None, :, None] for e in range(KvE)]
    s = qr.new_zeros(B, qr.shape[1], k.shape[2])
    for e in range(KvE):
        s = torch.where(own[e], torch.einsum("brd,btd->brt", qr,
                                             k[:, e].float()), s)
    s = s / math.sqrt(dh)
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    # a row with no valid position keeps a finite max, so p is all zero
    # and the l >= 1e-30 clamp returns zeros (as the kernel does)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    l = l_sum.clamp_min(1e-30)
    out = torch.zeros_like(qr)
    for e in range(KvE):
        out = torch.where(own[e], torch.einsum("brt,btd->brd", p,
                                               v[:, e].float()), out)
    out = out / l
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.where(l_sum > 0, m + torch.log(l), -1e30)
    return out, lse[..., 0]


def decode_attention_resident_plain(q, k, v, lengths, rows, kv_rows=None,
                                    *, return_lse: bool = False):
    """Plain PyTorch version of the kernel: a masked softmax over the
    gathered rows, accumulated in float32.  Same arguments and result as
    :func:`decode_attention_resident`."""
    T = k.shape[2]
    n = lengths.long().clamp(0, T)
    valid = torch.arange(T, device=q.device)[None, :] < n[:, None]
    return _masked_decode_plain(q, k, v, valid, rows, kv_rows, return_lse)


def decode_attention_ring_resident_plain(q, k, v, lengths, slot_pos, rows,
                                         kv_rows=None, *, window: int,
                                         return_lse: bool = False):
    """Plain version of :func:`decode_attention_ring_resident`: slot t of
    row b counts iff ``lengths[b] - window <= slot_pos[t] < lengths[b]``;
    a row with no valid slot returns zeros (and, with ``return_lse``, an
    LSE of -1e30)."""
    n = lengths.long()[:, None]
    pos = slot_pos.long()[None, :]
    valid = (pos < n) & (pos >= n - window)                 # (B, extent)
    return _masked_decode_plain(q, k, v, valid, rows, kv_rows, return_lse)


def _identity_rows(q):
    return torch.arange(q.shape[1], dtype=torch.int32, device=q.device)


def decode_attention_plain(q, k, v, lengths):
    """Plain version of :func:`decode_attention`: the resident plain
    version over identity rows."""
    return decode_attention_resident_plain(q, k, v, lengths,
                                           _identity_rows(q))


def decode_attention_int8_plain(q, k_q8, k_sc, v_q8, v_sc, lengths):
    """Plain version of :func:`decode_attention_int8`."""
    return decode_attention_int8_resident_plain(q, k_q8, k_sc, v_q8, v_sc,
                                                lengths, _identity_rows(q))


def _gather_pages(pages, page_map):
    """(n_pages, KvE, P, ...) pages through a (B, np) page map -> the
    position-ordered (B, KvE, np * P, ...) cache they hold."""
    g = pages[page_map.long()]                         # (B, np, KvE, P, ...)
    B, n, KvE, P = g.shape[:4]
    return g.transpose(1, 2).reshape((B, KvE, n * P) + g.shape[4:])


def decode_attention_int8_resident_plain(q, k_q8, k_sc, v_q8, v_sc, lengths,
                                         rows, kv_rows=None):
    """Plain version of :func:`decode_attention_int8_resident`: dequantize
    (``q8 · scale`` in float32), then the fp plain version."""
    return decode_attention_resident_plain(
        q, k_q8.float() * k_sc[..., None], v_q8.float() * v_sc[..., None],
        lengths, rows, kv_rows)


def decode_attention_paged_resident_plain(q, k_pages, v_pages, lengths,
                                          page_map, rows, kv_rows=None):
    """Plain version of :func:`decode_attention_paged_resident`: gather
    the pages in logical order, then the fp plain version."""
    return decode_attention_resident_plain(
        q, _gather_pages(k_pages, page_map), _gather_pages(v_pages, page_map),
        lengths, rows, kv_rows)


def decode_attention_int8_paged_resident_plain(q, k_q8, k_sc, v_q8, v_sc,
                                               lengths, page_map, rows,
                                               kv_rows=None):
    """Plain version of :func:`decode_attention_int8_paged_resident`:
    gather value and scale pages, dequantize, then the fp plain version."""
    def deq(x, sc):
        return _gather_pages(x, page_map).float() * _gather_pages(sc,
                                                                  page_map)
    return decode_attention_resident_plain(q, deq(k_q8, k_sc),
                                           deq(v_q8, v_sc), lengths, rows,
                                           kv_rows)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# argument types of each entry point of csrc/decode_attention.cu
_SIGNATURES = {
    "decode_attention_resident_launch":
        [_PTR] * 10 + [_INT] * 9 + [_I64] * 8 + [_PTR],
    "decode_attention_int8_resident_launch":
        [_PTR] * 11 + [_INT] * 8 + [_I64] * 14 + [_PTR],
    "decode_attention_paged_resident_launch":
        [_PTR] * 10 + [_INT] * 10 + [_I64] * 8 + [_PTR],
    "decode_attention_int8_paged_resident_launch":
        [_PTR] * 12 + [_INT] * 10 + [_I64] * 14 + [_PTR],
    "decode_attention_ring_resident_launch":
        [_PTR] * 11 + [_INT] * 10 + [_I64] * 8 + [_PTR],
}
# the ring kernel splits the window into pieces of a multiple of this many
# slots (a multiple of every head width's tile)
_RING_SPLIT_ALIGN = 128
# the split body splits the cache extent into pieces of a multiple of this
# many positions (two tiles of 32 at dh 64 and 128)
_DECODE_SPLIT_ALIGN = 64


@functools.lru_cache(maxsize=None)
def _launcher(entry: str):
    fn = getattr(build.load("decode_attention"), entry)
    fn.argtypes = _SIGNATURES[entry]
    fn.restype = _INT
    return fn


def _check(q, k, v, lengths, rows, kv_rows, *, batch_axis: bool):
    """Shapes and devices every variant shares: q (B, H, dh); k, v
    (B or n_pages, KvE, T or P, dh); lengths (B,); rows, kv_rows (R,)."""
    B, H, dh = q.shape
    lead = f"{B}" if batch_axis else "n_pages"
    if k.dim() != 4 or k.shape[3] != dh or v.shape != k.shape \
            or (batch_axis and k.shape[0] != B):
        raise ValueError(f"k/v must be ({lead}, KvE, T, dh) = ({lead}, KvE, "
                         f"T, {dh}); got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} q heads do not group over {k.shape[1]} "
                         f"KV heads")
    if lengths.shape != (B,) or rows.dim() != 1 \
            or kv_rows.shape != rows.shape:
        raise ValueError("lengths must be (B,), rows and kv_rows (R,)")
    return B, H, dh


def _check_scales(k, k_sc, v_sc, shape):
    if k_sc.shape != shape or v_sc.shape != shape:
        raise ValueError(f"scales must be {shape} for values "
                         f"{tuple(k.shape)}; got {tuple(k_sc.shape)} and "
                         f"{tuple(v_sc.shape)}")


def _check_page_map(page_map, B):
    if page_map.dim() != 2 or page_map.shape[0] != B:
        raise ValueError(f"page_map must be ({B}, np); got "
                         f"{tuple(page_map.shape)}")


def _on_cpu(q, *tensors) -> bool:
    """True for CPU tensors (the plain version runs); False for CUDA
    tensors (the kernel launches); raises for a mix or another device, and
    for inputs autograd would record (``kernels.refuse_autograd``)."""
    refuse_autograd("the decode attention kernel", q, *tensors)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"a tensor is on {t.device}, q on {q.device}")
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return False


def _check_kernel_inputs(q, k, v, dh, *, quant: bool):
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16 q; got {q.dtype}")
    want = torch.int8 if quant else q.dtype
    if k.dtype != want or v.dtype != want:
        raise ValueError(f"kernel takes {want} k/v with {q.dtype} q; got "
                         f"{k.dtype}, {v.dtype}")
    if dh not in SUPPORTED_DH:
        raise ValueError(f"kernel supports dh in {SUPPORTED_DH}, got {dh}")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a unit stride on dh")


def _launch(entry: str, q, R: int, pointers, ints, strides, name: str,
            scratch=(), out_dtype=None):
    """Allocate the (B, R, dh) output (in ``out_dtype``, q's by default)
    and launch ``entry`` on the current stream (``scratch`` tensors follow
    the output pointer, None for a null pointer); raises if the launch
    fails."""
    B, _, dh = q.shape
    out = torch.empty((B, R, dh), dtype=out_dtype or q.dtype,
                      device=q.device)
    if B == 0 or R == 0:
        return out, False
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(entry)(
            *[t.data_ptr() for t in pointers], out.data_ptr(),
            *[None if t is None else t.data_ptr() for t in scratch], *ints,
            dh, _DTYPE_CODES[q.dtype], q.stride(0), q.stride(1), *strides,
            stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out, True


def _i32(*tensors):
    return [t.to(torch.int32).contiguous() for t in tensors]


def _kv_rows(q, k, rows, kv_rows):
    return rows // (q.shape[1] // k.shape[1]) if kv_rows is None else kv_rows


def decode_attention_resident(q, k, v, lengths, rows, kv_rows=None, *,
                              return_lse: bool = False):
    """Flash-decode over only the head rows resident on this device.

    q: (B, H, dh) — the full q-head axis in its physical layout; k, v:
    (B, KvE, T, dh), any strides with a unit last stride (the model passes
    a transposed view of its (B, T, KvE, dh) cache); lengths: (B,) valid
    cache lengths, read as ``clamp(lengths, 0, T)``; rows: (R,) physical
    q-head rows; kv_rows: (R,) KV rows, default ``rows // (H // KvE)``.
    Returns the compacted (B, R, dh) slice in ``rows`` order, in q's dtype.
    The kernel needs 16-byte aligned k/v bases and strides (every model
    view has them) and launches as two CUDA kernels (sequence splits, then
    their merge); it counts one launch.

    ``return_lse``: returns (the output in float32, the (B, R) float32
    log-sum-exp of each row's valid scores q . k / sqrt(dh), -1e30 for a
    row with none) — a shard of a sequence-sharded cache's partials
    (``partitioning.SeqShard.merge``).  The output is the one q's dtype
    would round: cast, it equals the call without the flag bit for bit.
    """
    out, launched = _resident(q, k, v, lengths, rows, kv_rows, return_lse)
    decode_attention_resident.launches += launched
    return out


def _resident(q, k, v, lengths, rows, kv_rows, return_lse=False):
    """:func:`decode_attention_resident`'s body: (out — or (out, lse)
    with ``return_lse`` — and whether the kernel launched), for the
    wrapper that counts the launch under its name."""
    kv_rows = _kv_rows(q, k, rows, kv_rows)
    B, H, dh = _check(q, k, v, lengths, rows, kv_rows, batch_axis=True)
    if _on_cpu(q, k, v, lengths, rows, kv_rows):
        return decode_attention_resident_plain(
            q, k, v, lengths, rows, kv_rows, return_lse=return_lse), False
    _check_kernel_inputs(q, k, v, dh, quant=False)
    _check_aligned16(k, v)
    lengths, rows, kv_rows = _i32(lengths, rows, kv_rows)
    KvE, T, R = k.shape[1], k.shape[2], rows.shape[0]
    split = _decode_split(B, KvE, T, _sm_count(q.device))
    lse = _lse_out(q, R) if return_lse else None
    out, launched = _launch(
        "decode_attention_resident_launch", q, R,
        (q, k, v, lengths, rows, kv_rows),
        (B, H, KvE, T, R, split, int(return_lse)),
        (k.stride(0), k.stride(1), k.stride(2),
         v.stride(0), v.stride(1), v.stride(2)),
        "decode_attention_resident",
        scratch=_split_scratch(q, R, T, split) + (lse,),
        out_dtype=torch.float32 if return_lse else None)
    return ((out, lse) if return_lse else out), launched


def _lse_out(q, R: int):
    """The (B, R) float32 log-sum-exp output of a ``return_lse`` call."""
    return torch.empty((q.shape[0], R), dtype=torch.float32,
                       device=q.device)


def decode_attention_int8_resident(q, k_q8, k_sc, v_q8, v_sc, lengths, rows,
                                   kv_rows=None):
    """int8-KV twin of :func:`decode_attention_resident`: k_q8, v_q8
    (B, KvE, T, dh) int8 and k_sc, v_sc (B, KvE, T) float32
    per-(token, head) scales, any strides (a unit one on dh), dequantized
    in the kernel.  Returns the compacted (B, R, dh) slice in q's dtype.
    The kernel needs 16-byte aligned value bases and strides (scales: 4
    bytes) and launches as two CUDA kernels (sequence splits, then their
    merge); it counts one launch."""
    out, launched = _int8_resident(q, k_q8, k_sc, v_q8, v_sc, lengths, rows,
                                   kv_rows)
    decode_attention_int8_resident.launches += launched
    return out


def _int8_resident(q, k_q8, k_sc, v_q8, v_sc, lengths, rows, kv_rows):
    """:func:`decode_attention_int8_resident`'s body: (out, whether the
    kernel launched)."""
    kv_rows = _kv_rows(q, k_q8, rows, kv_rows)
    B, H, dh = _check(q, k_q8, v_q8, lengths, rows, kv_rows,
                      batch_axis=True)
    _check_scales(k_q8, k_sc, v_sc, k_q8.shape[:3])
    if _on_cpu(q, k_q8, k_sc, v_q8, v_sc, lengths, rows, kv_rows):
        return decode_attention_int8_resident_plain(
            q, k_q8, k_sc, v_q8, v_sc, lengths, rows, kv_rows), False
    _check_kernel_inputs(q, k_q8, v_q8, dh, quant=True)
    if k_sc.dtype != torch.float32 or v_sc.dtype != torch.float32:
        raise ValueError("kernel takes float32 scales")
    _check_aligned16(k_q8, v_q8)
    lengths, rows, kv_rows = _i32(lengths, rows, kv_rows)
    KvE, T, R = k_q8.shape[1], k_q8.shape[2], rows.shape[0]
    split = _decode_split(B, KvE, T, _sm_count(q.device))
    out, launched = _launch(
        "decode_attention_int8_resident_launch", q, R,
        (q, k_q8, k_sc, v_q8, v_sc, lengths, rows, kv_rows),
        (B, H, KvE, T, R, split),
        (k_q8.stride(0), k_q8.stride(1), k_q8.stride(2),
         v_q8.stride(0), v_q8.stride(1), v_q8.stride(2),
         k_sc.stride(0), k_sc.stride(1), k_sc.stride(2),
         v_sc.stride(0), v_sc.stride(1), v_sc.stride(2)),
        "decode_attention_int8_resident",
        scratch=_split_scratch(q, R, T, split))
    return out, launched


def decode_attention(q, k, v, lengths):
    """Flash-decode over every q head: q (B, H, dh), k/v (B, KvE, T, dh),
    lengths (B,) -> (B, H, dh).  The dense grid is the resident one with
    the identity gather map (rows = arange(H)): the split body of
    :func:`decode_attention_resident`, no kernel of its own.  Counts its
    launches in its own ``.launches``."""
    out, launched = _resident(q, k, v, lengths, _identity_rows(q), None)
    decode_attention.launches += launched
    return out


def decode_attention_int8(q, k_q8, k_sc, v_q8, v_sc, lengths):
    """int8-KV twin of :func:`decode_attention`: k_q8/v_q8 (B, KvE, T, dh)
    int8, k_sc/v_sc (B, KvE, T) float32 scales; the split body of
    :func:`decode_attention_int8_resident` over identity rows.  Counts
    its launches in its own ``.launches``."""
    out, launched = _int8_resident(q, k_q8, k_sc, v_q8, v_sc, lengths,
                                   _identity_rows(q), None)
    decode_attention_int8.launches += launched
    return out


def decode_attention_paged_resident(q, k_pages, v_pages, lengths, page_map,
                                    rows, kv_rows=None):
    """Flash-decode over a paged cache: resident head rows × live pages.

    k_pages, v_pages: (n_pages, KvE, P, dh) — the pooled page store, any
    strides with a unit last one (the model passes a view of its
    (n_pages, P, KvE, dh) store); page_map: (B, np) physical page ids in
    logical order, position t of row b at page ``page_map[b, t // P]``,
    offset ``t % P``; lengths are read as ``clamp(lengths, 0, np * P)``.
    Entries at or past a row's length are never read (callers clamp
    their -1 sentinels to 0); a page id it reads outside ``[0, n_pages)``
    gives NaN in the kernel.  rows/kv_rows as in
    :func:`decode_attention_resident`.  The kernel needs 16-byte aligned
    k/v bases and strides and launches as two CUDA kernels (sequence
    splits, then their merge); it counts one launch."""
    kv_rows = _kv_rows(q, k_pages, rows, kv_rows)
    B, H, dh = _check(q, k_pages, v_pages, lengths, rows, kv_rows,
                      batch_axis=False)
    _check_page_map(page_map, B)
    if _on_cpu(q, k_pages, v_pages, lengths, page_map, rows, kv_rows):
        return decode_attention_paged_resident_plain(
            q, k_pages, v_pages, lengths, page_map, rows, kv_rows)
    _check_kernel_inputs(q, k_pages, v_pages, dh, quant=False)
    _check_aligned16(k_pages, v_pages)
    lengths, page_map, rows, kv_rows = _i32(lengths, page_map, rows, kv_rows)
    n_pages, KvE, P = k_pages.shape[:3]
    R, cap = rows.shape[0], page_map.shape[1] * P
    split = _decode_split(B, KvE, cap, _sm_count(q.device))
    out, launched = _launch(
        "decode_attention_paged_resident_launch", q, R,
        (q, k_pages, v_pages, lengths, page_map, rows, kv_rows),
        (B, H, KvE, P, n_pages, page_map.shape[1], R, split),
        (k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
         v_pages.stride(0), v_pages.stride(1), v_pages.stride(2)),
        "decode_attention_paged_resident",
        scratch=_split_scratch(q, R, cap, split))
    decode_attention_paged_resident.launches += launched
    return out


def decode_attention_int8_paged_resident(q, k_q8, k_sc, v_q8, v_sc, lengths,
                                         page_map, rows, kv_rows=None):
    """Paged + int8 twin: k_q8, v_q8 (n_pages, KvE, P, dh) int8 pages and
    k_sc, v_sc (n_pages, KvE, P, 1) float32 scale pages — scales page
    exactly like values.  Otherwise as
    :func:`decode_attention_paged_resident`.  The kernel needs 16-byte
    aligned value bases and strides (scales: 4 bytes) and launches as two
    CUDA kernels (sequence splits, then their merge); it counts one
    launch."""
    kv_rows = _kv_rows(q, k_q8, rows, kv_rows)
    B, H, dh = _check(q, k_q8, v_q8, lengths, rows, kv_rows,
                      batch_axis=False)
    _check_scales(k_q8, k_sc, v_sc, k_q8.shape[:3] + (1,))
    _check_page_map(page_map, B)
    if _on_cpu(q, k_q8, k_sc, v_q8, v_sc, lengths, page_map, rows, kv_rows):
        return decode_attention_int8_paged_resident_plain(
            q, k_q8, k_sc, v_q8, v_sc, lengths, page_map, rows, kv_rows)
    _check_kernel_inputs(q, k_q8, v_q8, dh, quant=True)
    if k_sc.dtype != torch.float32 or v_sc.dtype != torch.float32:
        raise ValueError("kernel takes float32 scales")
    _check_aligned16(k_q8, v_q8)
    lengths, page_map, rows, kv_rows = _i32(lengths, page_map, rows, kv_rows)
    n_pages, KvE, P = k_q8.shape[:3]
    R, cap = rows.shape[0], page_map.shape[1] * P
    split = _decode_split(B, KvE, cap, _sm_count(q.device))
    out, launched = _launch(
        "decode_attention_int8_paged_resident_launch", q, R,
        (q, k_q8, k_sc, v_q8, v_sc, lengths, page_map, rows, kv_rows),
        (B, H, KvE, P, n_pages, page_map.shape[1], R, split),
        (k_q8.stride(0), k_q8.stride(1), k_q8.stride(2),
         v_q8.stride(0), v_q8.stride(1), v_q8.stride(2),
         k_sc.stride(0), k_sc.stride(1), k_sc.stride(2),
         v_sc.stride(0), v_sc.stride(1), v_sc.stride(2)),
        "decode_attention_int8_paged_resident",
        scratch=_split_scratch(q, R, cap, split))
    decode_attention_int8_paged_resident.launches += launched
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _decode_split(B: int, KvE: int, extent: int, sms: int) -> int:
    """Positions per sequence split of the split body: a multiple of
    ``_DECODE_SPLIT_ALIGN`` such that the (split, KV head, batch row) grid
    over the cache ``extent`` (T, or np * P when paged) holds about 4
    blocks per SM of a card with ``sms`` SMs (B 8, KvE 8, T 1024 on 132
    SMs: 128 positions, 8 splits, 512 blocks; glm4's B 8, KvE 2, T 8264:
    256, 33 splits, 528 blocks).  It reads no lengths: a split past a
    row's length costs its block an early exit, not a host sync."""
    want = max(1, -(-4 * sms // (B * KvE)))
    split = -(-extent // want)
    return max(1, -(-split // _DECODE_SPLIT_ALIGN)) * _DECODE_SPLIT_ALIGN


def _split_scratch(q, R: int, extent: int, split: int):
    """The splits' float32 partials: (m, l) (B, R, NS, 2) and acc
    (B, R, NS, dh), NS = ceil(extent / split)."""
    B, _, dh = q.shape
    n_splits = -(-extent // split)
    return (torch.empty((B, R, n_splits, 2), dtype=torch.float32,
                        device=q.device),
            torch.empty((B, R, n_splits, dh), dtype=torch.float32,
                        device=q.device))


def _check_aligned16(k, v):
    if not (build.aligned16(k) and build.aligned16(v)):
        raise ValueError("the kernel needs k/v with 16-byte aligned bases "
                         "and strides (cp.async copies)")


def _ring_split(B: int, KvE: int, extent: int, sms: int) -> int:
    """Slots per split of a ring buffer of ``extent`` slots: a multiple of
    ``_RING_SPLIT_ALIGN`` such that the (split, KV head, batch row) grid
    holds about 4 blocks per SM of a card with ``sms`` SMs (B 4, KvE 8, W
    4096 on 132 SMs: 256 slots, 16 splits, 512 blocks; B 1, a shard of
    1024 of mixtral's slots: 128, 8 splits)."""
    want = max(1, -(-4 * sms // (B * KvE)))
    split = max(1, -(-extent // want))
    return -(-split // _RING_SPLIT_ALIGN) * _RING_SPLIT_ALIGN


def decode_attention_ring_resident(q, k, v, lengths, slot_pos, rows,
                                   kv_rows=None, *, window: int,
                                   return_lse: bool = False):
    """Sliding-window flash-decode over a ring cache, over the resident
    head rows.

    k, v: (B, KvE, window, dh) ring buffers, any strides with a unit last
    one, for the kernel 16-byte aligned bases and strides of whole 16-byte
    pieces (the model passes a view of its (B, window, KvE, dh) ring);
    slot t holds absolute position ``slot_pos[t]`` ((window,) int32,
    shared by the batch; an empty slot holds -2**30); lengths: (B,) query
    position + 1.  Slot t counts for row b iff
    ``lengths[b] - window <= slot_pos[t] < lengths[b]``; a row with no
    valid slot returns zeros.  rows/kv_rows and the result as in
    :func:`decode_attention_resident`.  The kernel launches as two CUDA
    kernels (window splits, then their merge) and counts one launch.

    A buffer of ``extent`` < ``window`` slots (k/v (B, KvE, extent, dh),
    slot_pos (extent,)) is one device's share of a ring whose slots are
    sharded: validity still reads the whole window.  ``return_lse`` as in
    :func:`decode_attention_resident`."""
    kv_rows = _kv_rows(q, k, rows, kv_rows)
    B, H, dh = _check(q, k, v, lengths, rows, kv_rows, batch_axis=True)
    extent = k.shape[2]
    if extent > window or slot_pos.shape != (extent,):
        raise ValueError(f"a ring of window {window} needs k/v (B, KvE, "
                         f"extent <= {window}, dh) and slot_pos (extent,); "
                         f"got {tuple(k.shape)} and "
                         f"{tuple(slot_pos.shape)}")
    if _on_cpu(q, k, v, lengths, slot_pos, rows, kv_rows):
        return decode_attention_ring_resident_plain(
            q, k, v, lengths, slot_pos, rows, kv_rows, window=window,
            return_lse=return_lse)
    _check_kernel_inputs(q, k, v, dh, quant=False)
    _check_aligned16(k, v)
    lengths, slot_pos, rows, kv_rows = _i32(lengths, slot_pos, rows, kv_rows)
    KvE, R = k.shape[1], rows.shape[0]
    split = _ring_split(B, KvE, extent, _sm_count(q.device))
    lse = _lse_out(q, R) if return_lse else None
    out, launched = _launch(
        "decode_attention_ring_resident_launch", q, R,
        (q, k, v, lengths, slot_pos, rows, kv_rows),
        (B, H, KvE, extent, window, R, split, int(return_lse)),
        (k.stride(0), k.stride(1), k.stride(2),
         v.stride(0), v.stride(1), v.stride(2)),
        "decode_attention_ring_resident",
        scratch=_split_scratch(q, R, extent, split) + (lse,),
        out_dtype=torch.float32 if return_lse else None)
    decode_attention_ring_resident.launches += launched
    return (out, lse) if return_lse else out


for _fn in (decode_attention, decode_attention_int8,
            decode_attention_resident, decode_attention_int8_resident,
            decode_attention_paged_resident,
            decode_attention_int8_paged_resident,
            decode_attention_ring_resident):
    _fn.launches = 0
