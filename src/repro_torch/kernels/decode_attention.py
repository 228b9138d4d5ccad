"""Resident flash-decode: one query token per batch row against a long KV
cache, over only the q-head rows one device hosts — the paper's dominant
inference object, dispatched per (layer, device) from Algorithm 1's
placement.

Counterpart of the JAX package's ``kernels/decode_attention.py``
(``decode_attention_resident``, a Pallas TPU kernel).  Here the kernel is
hand-written CUDA C++ for Hopper (``csrc/decode_attention.cu``, built by
``kernels.build``).  ``decode_attention_resident`` launches it for CUDA
tensors and runs ``decode_attention_resident_plain`` — the same function
in plain PyTorch — only for tensors on the CPU.  There is no fallback: a
CUDA tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

SUPPORTED_DH = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_resident_plain(q, k, v, lengths, rows, kv_rows=None):
    """Plain PyTorch version of the kernel: a masked softmax over the
    gathered rows, accumulated in float32.  Same arguments and result as
    :func:`decode_attention_resident`."""
    B, H, dh = q.shape
    KvE, T = k.shape[1], k.shape[2]
    rows = rows.long()
    kv_rows = rows // (H // KvE) if kv_rows is None else kv_rows.long()
    qr = q.index_select(1, rows).float()                    # (B, R, dh)
    kr = k.index_select(1, kv_rows).float()                 # (B, R, T, dh)
    vr = v.index_select(1, kv_rows).float()
    s = torch.einsum("brd,brtd->brt", qr, kr) / math.sqrt(dh)
    n = lengths.long().clamp(0, T)
    valid = torch.arange(T, device=q.device)[None, :] < n[:, None]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    # a row with no valid position keeps a finite max, so p is all zero
    # and the l >= 1e-30 clamp returns zeros (as the kernel does)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("brt,brtd->brd", p, vr) / l
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("decode_attention").decode_attention_resident_launch
    i, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = [ptr] * 7 + [i] * 7 + [i64] * 8 + [ptr]
    fn.restype = i
    return fn


def _check(q, k, v, lengths, rows, kv_rows):
    B, H, dh = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != dh \
            or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, KvE, T, dh) = ({B}, KvE, T, "
                         f"{dh}); got {tuple(k.shape)} and {tuple(v.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} q heads do not group over {k.shape[1]} "
                         f"KV heads")
    if lengths.shape != (B,) or rows.dim() != 1 \
            or kv_rows.shape != rows.shape:
        raise ValueError("lengths must be (B,), rows and kv_rows (R,)")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths),
                    ("rows", rows), ("kv_rows", kv_rows)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return B, H, dh


def decode_attention_resident(q, k, v, lengths, rows, kv_rows=None):
    """Flash-decode over only the head rows resident on this device.

    q: (B, H, dh) — the full q-head axis in its physical layout; k, v:
    (B, KvE, T, dh), any strides with a unit last stride (the model passes
    a transposed view of its (B, T, KvE, dh) cache); lengths: (B,) valid
    cache lengths, read as ``clamp(lengths, 0, T)``; rows: (R,) physical
    q-head rows; kv_rows: (R,) KV rows, default ``rows // (H // KvE)``.
    Returns the compacted (B, R, dh) slice in ``rows`` order, in q's dtype.
    """
    if kv_rows is None:
        kv_rows = rows // (q.shape[1] // k.shape[1])
    B, H, dh = _check(q, k, v, lengths, rows, kv_rows)
    if q.device.type == "cpu":
        return decode_attention_resident_plain(q, k, v, lengths, rows,
                                               kv_rows)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in SUPPORTED_DH:
        raise ValueError(f"kernel supports dh in {SUPPORTED_DH}, got {dh}")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a unit stride on dh")
    lengths = lengths.to(torch.int32).contiguous()
    rows = rows.to(torch.int32).contiguous()
    kv_rows = kv_rows.to(torch.int32).contiguous()
    KvE, T = k.shape[1], k.shape[2]
    R = rows.shape[0]
    out = torch.empty((B, R, dh), dtype=q.dtype, device=q.device)
    if B == 0 or R == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            rows.data_ptr(), kv_rows.data_ptr(), out.data_ptr(),
            B, H, KvE, T, R, dh, _DTYPE_CODES[q.dtype],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), stream)
    if err:
        raise RuntimeError(f"decode_attention_resident launch failed: "
                           f"cudaError {err}")
    decode_attention_resident.launches += 1
    return out


decode_attention_resident.launches = 0
