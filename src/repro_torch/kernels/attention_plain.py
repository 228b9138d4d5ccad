"""Plain attention arithmetic in model layout ((B, S, Hp, dh) queries,
(B, T, KvE, dh) keys and values) — the reference's ``attention_scores``,
``chunked_attention`` and ``causal_mask`` (JAX package
``models/layers.py``).

It lives under ``kernels/`` because two callers share it: the model's
``attend`` (``models/layers.py``) and the plain version of the flash
attention kernel (``kernels/flash_attention.py``), which must repeat the
model's arithmetic bit for bit; ``models/layers.py`` imports
``kernels.ops``, so the shared code cannot live there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def attention_scores(q, k, v, mask):
    """q: (B,S,Hp,dh), k/v: (B,T,KvE,dh), mask: broadcastable to
    (B,1,1,S,T) or None. Returns (B,S,Hp,dh). Scores and softmax in f32."""
    B, S, Hp, dh = q.shape
    T, KvE = k.shape[1], k.shape[2]
    # The KV extent is padded with masked keys to a multiple of 16, and to
    # at least 64.  torch's CPU batched matmul computes a product with
    # fewer than 16 columns, or fewer than 400 multiply-adds, in another
    # summation order than a larger one, and its softmax sums a row shorter
    # than its vector width (16 floats with AVX-512) in another order than
    # a longer one.  Past both edges a valid prefix gets the same scores
    # and probabilities at any extent, so a dense prefill bucket of 8
    # tokens and the paged cache (which attends over the page table's
    # whole span) agree bit for bit.  Padded keys score -inf, below a
    # masked key's -1e30: a row with a valid key gives both weight 0, and
    # a fully masked row (an imageless cross-attention row) averages V
    # over its T keys, as the reference's unpadded softmax does.
    pad = max(64, -(-T // 16) * 16) - T
    if pad:
        if mask is None:
            mask = torch.ones((1, 1, 1, 1, T), dtype=torch.bool,
                              device=q.device)
        k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
        mask = F.pad(mask, (0, pad), value=False)
    qg = q.reshape(B, S, KvE, Hp // KvE, dh)
    scores = torch.einsum("bsegd,bted->begst", qg.float(), k.float())
    scores = scores / math.sqrt(dh)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    if pad:
        scores[..., T:] = -math.inf
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("begst,bted->bsegd", probs.to(v.dtype), v)
    return out.reshape(B, S, Hp, dh)


def chunked_attention(q, k, v, q_positions, kv_positions, *,
                      causal: bool = True, window: int = 0,
                      chunk: int = 1024):
    """Flash-style attention in plain PyTorch: a loop over KV chunks with an
    online softmax (m, l, acc) — peak memory O(S·chunk) instead of O(S·T).
    Same arithmetic as the reference's ``chunked_attention`` (q scaled in
    float32 first, masked scores at -1e30, ``l`` clamped at 1e-30).

    q: (B,S,Hp,dh); k/v: (B,T,KvE,dh); positions (B,S)/(B,T); ``window``
    > 0 keeps only keys within ``window`` positions of the query.  Returns
    (B,S,Hp,dh) in q's dtype."""
    B, S, Hp, dh = q.shape
    T, KvE = k.shape[1], k.shape[2]
    G = Hp // KvE
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"KV extent {T} is not a multiple of chunk {chunk}")
    qg = (q.float() * (1.0 / math.sqrt(dh))).reshape(B, S, KvE, G, dh)
    m = torch.full((B, KvE, G, S), NEG_INF, device=q.device)
    l = torch.zeros((B, KvE, G, S), device=q.device)
    acc = torch.zeros((B, KvE, G, S, dh), device=q.device)
    qp = q_positions[:, :, None]
    for c0 in range(0, T, chunk):
        pb = kv_positions[:, None, c0:c0 + chunk]               # (B,1,C)
        s = torch.einsum("bsegd,bted->begst", qg,
                         k[:, c0:c0 + chunk].float())
        if causal:
            pred = pb <= qp
            if window > 0:
                pred &= pb > qp - window
            s = torch.where(pred[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "begst,bted->begsd", p, v[:, c0:c0 + chunk].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hp, dh).to(q.dtype)


def attend(q, k, v, q_positions, kv_positions, mask, *, causal: bool = True,
           window: int = 0):
    """The reference's ``attend`` dispatch: ``chunked_attention`` (1024-key
    chunks) when more than one query meets a KV extent of at least 2048
    that is a multiple of 1024, else ``attention_scores`` under ``mask``
    (None when ``causal`` is False)."""
    S, T = q.shape[1], k.shape[1]
    if S > 1 and T >= 2048 and T % 1024 == 0:
        return chunked_attention(q, k, v, q_positions, kv_positions,
                                 causal=causal, window=window, chunk=1024)
    return attention_scores(q, k, v, mask)


def causal_mask(q_positions, kv_positions, window: int = 0):
    """(B,1,1,S,T) boolean; True = attend.  window=0 means full causal."""
    m = kv_positions[:, None, :] <= q_positions[:, :, None]
    if window > 0:
        m &= kv_positions[:, None, :] > (q_positions[:, :, None] - window)
    return m[:, None, None, :, :]
