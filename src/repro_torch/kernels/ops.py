"""Model-layout wrappers of the kernels ((B, S, H, dh) activations,
(B, T, KvE, dh) caches) — counterpart of the JAX package's
``kernels/ops.py``.

The JAX wrapper transposes the whole per-layer cache into the kernel
layout; here the kernel reads the cache through its strides, so the
wrapper passes a transposed *view* and nothing is copied.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention_resident


def decode_attention_resident_bshd(q, k, v, lengths, rows, kv_rows=None, *,
                                   inv_rows=None):
    """Placement-driven decode: model layout q (B,1,H,dh), cache k/v
    (B,T,KvE,dh), ``rows`` (R,) the physical q-head rows this dispatch
    covers.  Returns the compacted (B,1,R,dh) slice in ``rows`` order —
    or, when ``inv_rows`` (the scatter map with R == H) is given, the full
    (B,1,H,dh) tensor in physical q order, ready for the wo projection."""
    o = decode_attention_resident(q[:, 0], k.transpose(1, 2),
                                  v.transpose(1, 2), lengths, rows, kv_rows)
    if inv_rows is not None:
        o = o.index_select(1, inv_rows)
    return o[:, None]
