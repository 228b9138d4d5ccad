"""Mamba-2 (SSD) block — the backbone of the Zamba2 hybrid — counterpart of
the JAX package's ``models/mamba2.py``.

A fused in-projection to (z, x, B, C, dt), a causal depthwise conv over
(x, B, C), a scalar decay per head a = exp(-exp(A_log) * dt), a state
h in R^{nh x dh x n_state} per head, y = C.h + D*x, a gated RMSNorm and the
out-projection; one group (ngroups = 1).  The decode state is O(1) in the
sequence: the conv's tail (width - 1 tokens, in the working dtype) and the
SSM state (float32).

Plain torch, as the reference is plain ``jnp`` here (it runs no Pallas
kernel in this block).  ``ssd_scan`` is the reference's sequential
recurrence, one token at a time in float32; the casts sit where the
reference puts them.  The reference's sharding constraints
(``part.constrain``) have no counterpart on one card.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import torch_dtype


def mamba_dims(cfg: ModelConfig):
    """(d_inner, SSM heads, head dim, state size, conv width)."""
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv


def init_mamba_layer(gen: torch.Generator, cfg: ModelConfig, lead: tuple,
                     dtype, device) -> dict:
    """One Mamba-2 layer's weights stacked over ``lead``, at the reference's
    init scales (``w_in``, ``conv_w``, ``w_out`` drawn in that order).  As
    in the reference, ``conv_b``, ``A_log`` and ``dt_bias`` start at zero
    and ``D`` at one; ``A_log``, ``D`` and ``dt_bias`` are float32."""
    D = cfg.d_model
    d_in, nh, dh, ns, cw = mamba_dims(cfg)
    conv_ch = d_in + 2 * ns

    def full(shape, value, dt=dtype):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        "ln": full((D,), 1.0),
        "w_in": L.dense_init(gen, D, lead + (D, 2 * d_in + 2 * ns + nh),
                             dtype, device),
        "conv_w": L.dense_init(gen, cw, lead + (cw, conv_ch), dtype, device),
        "conv_b": full((conv_ch,), 0.0),
        "A_log": full((nh,), 0.0, torch.float32),
        "D": full((nh,), 1.0, torch.float32),
        "dt_bias": full((nh,), 0.0, torch.float32),
        "norm": full((d_in,), 1.0),
        "w_out": L.dense_init(gen, d_in, lead + (d_in, D), dtype, device),
    }


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv.  xBC: (B, S, C); conv_w: (cw, C); conv_state:
    (B, cw - 1, C), the tail of the previous call (decode), or None (a zero
    history).  Sums in float32, adds the bias, applies SiLU and casts to
    xBC's dtype.  Returns (out (B, S, C), new_state: the last cw - 1 tokens
    of history and input, in their dtype)."""
    B, S, C = xBC.shape
    cw = conv_w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B, cw - 1, C), dtype=xBC.dtype,
                                 device=xBC.device)
    full = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)  # (B, S+cw-1, C)
    # windows: out[t] = sum_i w[i] * full[t + i]
    out = torch.zeros((B, S, C), dtype=torch.float32, device=xBC.device)
    for i in range(cw):
        out = out + full[:, i:i + S, :].float() * conv_w[i].float()
    out = out + conv_b.float()
    new_state = full[:, -(cw - 1):, :]
    return F.silu(out).to(xBC.dtype), new_state


def ssd_scan(xh, Bt, Ct, a, dtv, h0):
    """The SSD recurrence in float32, one token at a time.

    xh: (B, S, nh, dh); Bt, Ct: (B, S, ns); a: (B, S, nh) decays in (0, 1);
    dtv: (B, S, nh); h0: (B, nh, dh, ns), not written.  Per token:
    h = a h + (x dt) B^T, y = h C.  Returns y (B, S, nh, dh) and the final
    state, both float32."""
    xh, Bt, Ct, a, dtv = (t.float() for t in (xh, Bt, Ct, a, dtv))
    h = h0.to(torch.float32, copy=True)
    ys = []
    for t in range(xh.shape[1]):
        dx = xh[:, t] * dtv[:, t, :, None]                    # (B, nh, dh)
        h = h * a[:, t, :, None, None] \
            + dx[..., None] * Bt[:, t, None, None, :]
        ys.append(torch.matmul(h, Ct[:, t, None, :, None])[..., 0])
    return torch.stack(ys, dim=1), h


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba_block(cfg: ModelConfig, p: dict, x, state: Dict):
    """x: (B, S, D); state {"conv": (B, cw - 1, C), "ssm": (B, nh, dh, ns)}
    (zeros for a fresh sequence), not written.  Returns (out (B, S, D),
    new_state)."""
    d_in, nh, dh, ns, cw = mamba_dims(cfg)
    B, S, _ = x.shape
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = h @ p["w_in"].to(h.dtype)
    z, xs, Bt, Ct, dtl = torch.split(zxbcdt, [d_in, d_in, ns, ns, nh],
                                     dim=-1)
    xBC = torch.cat([xs, Bt, Ct], dim=-1)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                 state["conv"])
    xs, Bt, Ct = torch.split(xBC, [d_in, ns, ns], dim=-1)
    dtv = _softplus(dtl.float() + p["dt_bias"].float())       # (B, S, nh)
    a = torch.exp(-torch.exp(p["A_log"].float()) * dtv)       # (B, S, nh)
    xh = xs.reshape(B, S, nh, dh)
    y, new_ssm = ssd_scan(xh, Bt, Ct, a, dtv, state["ssm"])
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in)
    # gated RMSNorm (mamba2's norm(y * silu(z))), cast back first
    y = y * F.silu(z.float())
    y = L.rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"].to(y.dtype)
    return out, {"conv": new_conv, "ssm": new_ssm}


def zero_mamba_state(cfg: ModelConfig, batch: int, lead=(), *,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """The conv tails (in ``cfg.dtype``) and SSM states (float32) of a fresh
    sequence, stacked over ``lead``."""
    d_in, nh, dh, ns, cw = mamba_dims(cfg)
    C = d_in + 2 * ns
    return {
        "conv": torch.zeros(lead + (batch, cw - 1, C),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "ssm": torch.zeros(lead + (batch, nh, dh, ns), dtype=torch.float32,
                           device=device),
    }
