"""Plain PyTorch oracle over the full head grid, in kernel layout —
counterpart of the JAX package's ``kernels/ref.decode_attention_ref``.
Written independently of the kernel's plain version (softmax over a
-inf-masked score row), so tests can hold one against the other."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, lengths):
    """q: (B,H,dh) one query token; k,v: (B,KvE,T,dh); lengths: (B,) valid
    cache lengths (1..T). Returns (B,H,dh) in q's dtype."""
    B, H, dh = q.shape
    KvE, T = k.shape[1], k.shape[2]
    qg = q.reshape(B, KvE, H // KvE, dh).float()
    s = torch.einsum("begd,betd->begt", qg, k.float()) / math.sqrt(dh)
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("begt,betd->begd", p, v.float())
    return o.reshape(B, H, dh).to(q.dtype)
