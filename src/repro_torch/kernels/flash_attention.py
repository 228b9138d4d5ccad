"""Flash attention for prefill: causal, sliding-window or non-causal GQA
attention of Sq queries over Skv keys — counterpart of the JAX package's
``kernels/flash_attention.py``, whose Pallas TPU kernel ``flash_attention``
is here a hand-written CUDA C++ kernel for Hopper
(``csrc/flash_attention.cu``, built by ``kernels.build``).

q (B, H, Sq, dh); k, v (B, KvE, Skv, dh) with ``H % KvE == 0``, head h
reading KV group ``h // (H // KvE)``.  ``causal`` lets row i attend the
columns j <= i, rows and columns aligned at the top left (row i is
position i, column j position j, also when Sq != Skv); ``window`` > 0 then
keeps only j > i - window.  Without ``causal`` every column is attended and
``window`` is ignored.

``flash_attention`` launches the kernel for CUDA tensors and counts the
launch in its ``.launches``; it runs ``flash_attention_plain`` — the model's
own prefill arithmetic on these positions — only for tensors on the CPU.
There is no fallback: a CUDA tensor the kernel does not take (a head width
outside ``SUPPORTED_DH``: 16, 32, 64, zamba2's 80 and 128) raises, and so
does an input autograd would record: the kernel has no backward
(``kernels.refuse_autograd``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.attention_plain import attend, causal_mask

SUPPORTED_DH = (16, 32, 64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain PyTorch version of :func:`flash_attention`: the reference
    model's ``attend`` on the aligned positions ``arange(Sq)`` and
    ``arange(Skv)`` — ``attention_scores`` under ``causal_mask`` below a KV
    extent of 2048, ``chunked_attention`` in 1024-key chunks at or above it
    when the extent is a multiple of 1024.  It is the model's arithmetic
    bit for bit, so a prefill through this wrapper on the CPU gives the
    logits of the model's own prefill.  Same arguments and result as
    :func:`flash_attention` (the result is a view of (B, Sq, H, dh)
    memory)."""
    B, Sq, Skv = q.shape[0], q.shape[2], k.shape[2]
    q_pos = torch.arange(Sq, device=q.device)[None].expand(B, Sq)
    kv_pos = torch.arange(Skv, device=q.device)[None].expand(B, Skv)
    mask = causal_mask(q_pos, kv_pos, window) if causal else None
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 q_pos, kv_pos, mask, causal=causal, window=window)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_PTR] * 4 + [_INT] * 9 + [_I64] * 12 + [_PTR]
    fn.restype = _INT
    return fn


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, Sq, dh) and k (B, KvE, Skv, dh); "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v must have k's shape {tuple(k.shape)}; got "
                         f"{tuple(v.shape)}")
    B, H, Sq, dh = q.shape
    KvE = k.shape[1]
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k must be ({B}, KvE, Skv, {dh}); got "
                         f"{tuple(k.shape)}")
    if KvE == 0 or H % KvE:
        raise ValueError(f"H={H} query heads must be a multiple of KvE={KvE}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"a tensor is on {t.device}, q on {q.device}")


def _check_kernel_inputs(q, k, v):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    dh = q.shape[3]
    if dh not in SUPPORTED_DH:
        raise ValueError(f"kernel supports dh in {SUPPORTED_DH}, got {dh}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride on dh")
    if not all(build.aligned16(t) for t in (q, k, v)):
        raise ValueError("q, k and v need 16-byte aligned bases and strides "
                         "of whole 16-byte pieces (multiples of 8 values "
                         "at bf16)")
    if q.shape[0] > _MAX_GRID_YZ or q.shape[1] > _MAX_GRID_YZ:
        raise ValueError(f"kernel takes at most {_MAX_GRID_YZ} batch rows "
                         f"and heads")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention of q (B, H, Sq, dh) over k, v (B, KvE, Skv, dh), any
    strides with a unit last one, the others whole 16-byte pieces from a
    16-byte aligned base (the model passes transposed views of its
    (B, S, H, dh) activations and (B, T, KvE, dh) caches), in float32 or
    bfloat16 with dh in ``SUPPORTED_DH``; any Sq and Skv.  Masks as the
    module docstring says; a row that attends no key returns zeros.
    Returns (B, H, Sq, dh) in q's dtype, a view of (B, Sq, H, dh) memory —
    the model's layout, so the caller's transpose back is free."""
    _check(q, k, v, window)
    refuse_autograd("the flash attention kernel", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_kernel_inputs(q, k, v)
    B, H, Sq, dh = q.shape
    KvE, Skv = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, dh), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    if B * H * Sq == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
            KvE, Sq, Skv, dh, _DTYPE_CODES[q.dtype], int(causal),
            int(window),
            *(s for t in (q, k, v, o) for s in t.stride()[:3]), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
