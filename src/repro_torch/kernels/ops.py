"""Model-layout wrappers of the kernels ((B, S, H, dh) activations,
(B, T, KvE, dh) keys, caches and rings, (n_pages, P, KvE, dh) page
stores) — counterpart of the JAX package's ``kernels/ops.py``.

The JAX wrappers transpose the whole per-layer cache (or page store, or
the prefill or RWKV activations) into the kernel layout; here the kernels
read through strides, so the wrappers pass transposed *views* and nothing
is copied.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_int8_paged_resident, decode_attention_int8_resident,
    decode_attention_paged_resident, decode_attention_resident,
    decode_attention_ring_resident)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rwkv6 import rwkv6_chunked


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0):
    """Prefill attention in model layout: q (B,S,H,dh), k/v (B,T,KvE,dh) ->
    (B,S,H,dh), rows and columns aligned at the top left (row i is position
    i, column j position j).  The kernel reads transposed views; its output
    is already (B,S,H,dh) memory."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)


def _scatter(o, inv_rows):
    """(B, R, dh) kernel output -> (B, 1, R, dh), or the full (B, 1, H, dh)
    in physical q order when the scatter map ``inv_rows`` is given."""
    if inv_rows is not None:
        o = o.index_select(1, inv_rows)
    return o[:, None]


def decode_attention_bshd(q, k, v, lengths):
    """Decode over every q head in model layout: q (B,1,H,dh), cache k/v
    (B,T,KvE,dh), lengths (B,) -> (B,1,H,dh) (identity rows)."""
    return decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                            lengths)[:, None]


def decode_attention_resident_bshd(q, k, v, lengths, rows, kv_rows=None, *,
                                   inv_rows=None):
    """Placement-driven decode: model layout q (B,1,H,dh), cache k/v
    (B,T,KvE,dh), ``rows`` (R,) the physical q-head rows this dispatch
    covers.  Returns the compacted (B,1,R,dh) slice in ``rows`` order —
    or, when ``inv_rows`` (the scatter map with R == H) is given, the full
    (B,1,H,dh) tensor in physical q order, ready for the wo projection."""
    o = decode_attention_resident(q[:, 0], k.transpose(1, 2),
                                  v.transpose(1, 2), lengths, rows, kv_rows)
    return _scatter(o, inv_rows)


def decode_attention_int8_resident_bshd(q, k_q8, k_sc, v_q8, v_sc, lengths,
                                        rows, kv_rows=None, *, inv_rows=None):
    """int8-KV twin of :func:`decode_attention_resident_bshd`: cache
    k_q8/v_q8 (B,T,KvE,dh) int8 with per-(token, head) scales k_sc/v_sc
    (B,T,KvE), dequantized in the kernel."""
    o = decode_attention_int8_resident(
        q[:, 0], k_q8.transpose(1, 2), k_sc.transpose(1, 2),
        v_q8.transpose(1, 2), v_sc.transpose(1, 2), lengths, rows, kv_rows)
    return _scatter(o, inv_rows)


def decode_attention_paged_bshd(q, k_pages, v_pages, lengths, page_map,
                                rows, kv_rows=None, *, inv_rows=None):
    """Paged decode in model layout: q (B,1,H,dh), page store k/v
    (n_pages, P, KvE, dh), ``page_map`` (B, np) int32 physical page ids
    in logical order (callers clamp unmapped -1 entries to 0 — the
    length mask hides them).  ``rows``/``inv_rows`` as in
    :func:`decode_attention_resident_bshd`."""
    o = decode_attention_paged_resident(
        q[:, 0], k_pages.transpose(1, 2), v_pages.transpose(1, 2), lengths,
        page_map, rows, kv_rows)
    return _scatter(o, inv_rows)


def decode_attention_int8_paged_bshd(q, k_q8, k_sc, v_q8, v_sc, lengths,
                                     page_map, rows, kv_rows=None, *,
                                     inv_rows=None):
    """int8-KV twin of :func:`decode_attention_paged_bshd`: page store
    k_q8/v_q8 (n_pages, P, KvE, dh) int8 with per-(token, head) scale
    pages k_sc/v_sc (n_pages, P, KvE)."""
    o = decode_attention_int8_paged_resident(
        q[:, 0], k_q8.transpose(1, 2), k_sc.transpose(1, 2)[..., None],
        v_q8.transpose(1, 2), v_sc.transpose(1, 2)[..., None], lengths,
        page_map, rows, kv_rows)
    return _scatter(o, inv_rows)


def decode_attention_ring_bshd(q, k, v, lengths, slot_pos, *, window: int,
                               rows, kv_rows=None, inv_rows=None):
    """Sliding-window ring-cache decode in model layout: q (B,1,H,dh), ring
    k/v (B,window,KvE,dh), ``slot_pos`` (window,) the absolute position
    each ring slot holds — the kernel masks by position instead of
    rotating the buffer (softmax does not depend on the slots' order).
    ``rows``/``inv_rows`` as in :func:`decode_attention_resident_bshd`."""
    o = decode_attention_ring_resident(
        q[:, 0], k.transpose(1, 2), v.transpose(1, 2), lengths, slot_pos,
        rows, kv_rows, window=window)
    return _scatter(o, inv_rows)


def rwkv6(r, k, v, w, u, state, *, out_state=None):
    """The WKV6 recurrence in model layout: r/k/v/w (B,S,H,dh), u (H,dh),
    state (B,H,dh,dh) float32.  Returns y (B,S,H,dh) float32 (contiguous
    from the kernel) and the final state, written into ``out_state`` (which
    may be ``state``) when given."""
    y, s = rwkv6_chunked(r.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), w.transpose(1, 2), u, state,
                         out_state=out_state)
    return y.transpose(1, 2), s
