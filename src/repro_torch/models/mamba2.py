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
reference puts them.

On a mesh (``shard``, a ``partitioning.HeadShard``) the block runs on a
rank's local tensors: its columns of ``w_in`` (cut evenly over "model",
blind to the (z, x, B, C, dt) split) are gathered over "model", so every
rank has the whole projection; the depthwise conv runs on the rank's
channel shard of the conv state (its channels of x, B and C, as the
decode-state rule cuts them) and its output is gathered too, for each
rank's heads of x and the whole B and C (one group: every head reads
them).  The SSD scan runs on the rank's SSM heads with its state shard,
the gated RMSNorm sums its squares over "model" (it normalizes over the
whole d_inner), and the rank's rows of ``w_out`` give a partial output,
summed over "model".  The reference's ``part.constrain`` points are the
state shards' layout, checked by the model (``zamba2``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.partitioning import HeadShard
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


def gated_rms_norm(y, scale, eps: float, width: int, sum_ranks):
    """The Mamba-2 gated RMSNorm's normalization of ``y`` (B, S, n): n of
    the ``width`` channels it normalizes over, the others on other ranks;
    ``sum_ranks`` sums a tensor over those ranks (the mean square is taken
    over every channel, not the rank's slice).  ``scale``: the slice's
    scales.  Float32 inside, cast back to y's dtype, as ``rms_norm``."""
    y32 = y.float()
    var = sum_ranks(y32.square().sum(dim=-1, keepdim=True)) / width
    out = y32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(y.dtype)


def mamba_block(cfg: ModelConfig, p: dict, x, state: Dict, shard=None):
    """x: (B, S, D); state {"conv": (B, cw - 1, C), "ssm": (B, nh, dh, ns)}
    (zeros for a fresh sequence), not written.  Returns (out (B, S, D),
    new_state).  ``shard`` (``partitioning.HeadShard``): on a mesh, this
    rank's part — ``p`` holds its shards of ``w_in`` (columns) and
    ``w_out`` (rows) and the replicated rest, ``state`` its conv channels
    and SSM heads, and the output is summed over "model" (module doc);
    None: the whole block."""
    d_in, nh, dh, ns, cw = mamba_dims(cfg)
    B, S, _ = x.shape
    shard = shard or HeadShard((0, B))
    lo, n = shard.heads(nh)                 # this rank's SSM heads
    c0, cn = shard.span(d_in + 2 * ns)      # and conv channels
    heads = slice(lo * dh, (lo + n) * dh)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = shard.gather(h @ p["w_in"].to(h.dtype),
                          2 * d_in + 2 * ns + nh)
    z = zxbcdt[..., heads]
    dtl = zxbcdt[..., 2 * d_in + 2 * ns + lo:2 * d_in + 2 * ns + lo + n]
    xBC, new_conv = _causal_conv(zxbcdt[..., d_in + c0:d_in + c0 + cn],
                                 p["conv_w"][:, c0:c0 + cn],
                                 p["conv_b"][c0:c0 + cn], state["conv"])
    xBC = shard.gather(xBC, d_in + 2 * ns)
    xs = xBC[..., heads]
    Bt, Ct = xBC[..., d_in:d_in + ns], xBC[..., d_in + ns:]
    dtv = _softplus(dtl.float() + p["dt_bias"][lo:lo + n].float())
    a = torch.exp(-torch.exp(p["A_log"][lo:lo + n].float()) * dtv)
    xh = xs.reshape(B, S, n, dh)
    y, new_ssm = ssd_scan(xh, Bt, Ct, a, dtv, state["ssm"])
    y = y + p["D"][lo:lo + n].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, n * dh)
    # gated RMSNorm (mamba2's norm(y * silu(z))), cast back first
    y = y * F.silu(z.float())
    if shard.model is None:
        y = L.rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    else:
        y = gated_rms_norm(y.to(x.dtype), p["norm"][heads], cfg.norm_eps,
                           d_in, shard.reduce)
    out = shard.reduce(y @ p["w_out"].to(y.dtype))
    return out, {"conv": new_conv, "ssm": new_ssm}


def zero_mamba_state(cfg: ModelConfig, batch: int, lead=(), *,
                     device="cpu", shard=None) -> Dict[str, torch.Tensor]:
    """The conv tails (in ``cfg.dtype``) and SSM states (float32) of a fresh
    sequence, stacked over ``lead``; with ``shard`` only this rank's conv
    channels and SSM heads."""
    d_in, nh, dh, ns, cw = mamba_dims(cfg)
    C = d_in + 2 * ns
    if shard is not None:
        C, nh = shard.span(C)[1], shard.heads(nh)[1]
    return {
        "conv": torch.zeros(lead + (batch, cw - 1, C),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "ssm": torch.zeros(lead + (batch, nh, dh, ns), dtype=torch.float32,
                           device=device),
    }
