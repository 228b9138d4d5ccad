"""Plain PyTorch oracles over the full head grid, in kernel layout —
counterpart of the JAX package's ``kernels/ref.flash_attention_ref`` and
``decode_attention_ref``, plus one for the sliding-window ring, and the
WKV6 recurrence.  Written independently of the kernels' plain versions
(softmax over a -inf-masked score row; the recurrence over the stacked
time axis), so tests can hold one against the other."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """q: (B,H,Sq,dh); k,v: (B,KvE,Skv,dh). GQA: H % KvE == 0.
    Returns (B,H,Sq,dh) in q.dtype; softmax in f32 over a -inf-masked
    score row (causal: key j <= query i, aligned at the top left)."""
    B, H, Sq, dh = q.shape
    KvE, Skv = k.shape[1], k.shape[2]
    G = H // KvE
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, KvE, G, Sq, dh)
    s = torch.einsum("begsd,betd->begst", qg.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("begst,betd->begsd", p, v.float())
    return o.reshape(B, H, Sq, dh).to(q.dtype)


def decode_attention_ref(q, k, v, lengths):
    """q: (B,H,dh) one query token; k,v: (B,KvE,T,dh); lengths: (B,) valid
    cache lengths (1..T). Returns (B,H,dh) in q's dtype."""
    T = k.shape[2]
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    return _softmax_attend(q, k, v, mask)


def decode_attention_ring_ref(q, k, v, lengths, slot_pos, window: int):
    """q: (B,H,dh); ring k,v: (B,KvE,window,dh) whose slot t holds absolute
    position ``slot_pos[t]``; lengths: (B,) query position + 1, each with
    at least one slot in ``[lengths - window, lengths)``."""
    pos = slot_pos[None, :]
    n = lengths[:, None]
    return _softmax_attend(q, k, v, (pos < n) & (pos >= n - window))


def _softmax_attend(q, k, v, mask):
    """Softmax over the (B, T) positions ``mask`` admits, per q head."""
    B, H, dh = q.shape
    KvE = k.shape[1]
    qg = q.reshape(B, KvE, H // KvE, dh).float()
    s = torch.einsum("begd,betd->begt", qg, k.float()) / math.sqrt(dh)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("begt,betd->begd", p, v.float())
    return o.reshape(B, H, dh).to(q.dtype)


def rwkv6_ref(r, k, v, w, u, state):
    """WKV6 recurrence. r,k,v,w: (B,H,S,dh); u: (H,dh); state: (B,H,dh,dh)
    (S[i,j] = key i, value j).  Returns y (B,H,S,dh) float32 and the final
    state, float32."""
    r, k, v, w = (t.float().movedim(2, 0) for t in (r, k, v, w))
    u = u.float()
    s = state.float()
    ys = []
    for r_t, k_t, v_t, w_t in zip(r, k, v, w):
        y = torch.einsum("bhi,bhij->bhj", r_t, s)
        bonus = torch.einsum("bhi,hi,bhi->bh", r_t, u, k_t)
        ys.append(y + bonus[..., None] * v_t)
        s = w_t[..., None] * s + k_t[..., None] * v_t[:, :, None, :]
    return torch.stack(ys, dim=2), s
