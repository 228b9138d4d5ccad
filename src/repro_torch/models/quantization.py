"""Weight-only int8 quantization for serving — counterpart of the JAX
package's ``models/quantization.py``.

Symmetric per-last-axis int8: a float weight W becomes
``{"q8": int8, "sc": float32[stack dims..., last_dim]}`` with
W ≈ q8 * sc.  The model reads each weight through :func:`wt`, which
dequantizes the layer slice it is handed, so the resident footprint is
int8 (half of bf16) and only one layer's weights exist in the working
dtype at a time.

Only matmul weights of the transformer family are quantized (attention
projections, MLP/MoE experts, embeddings, lm head); norms, biases, gates
and router weights stay in full precision.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.partitioning import (Sharding, from_local,
                                             is_dtensor, local)

# base (unstacked) rank of each quantizable weight; leading stack axes
# (the layer axis, the VLM's supergroups) keep per-layer scales
_BASE_NDIM = {"wq": 3, "wk": 3, "wv": 3, "wo": 3,
              "tok_embed": 2, "lm_head": 2,
              "w_gate": 2, "w_up": 2, "w_down": 2}    # 3 inside "moe"
QUANT_NAMES = tuple(_BASE_NDIM)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "q8" in leaf


def _broadcast_scale(sc, ndim: int):
    """Scales (stack dims..., last) reshaped to broadcast over a weight of
    ``ndim`` axes: ones on the base axes but the last."""
    return sc.reshape(sc.shape[:-1] + (1,) * (ndim - sc.dim())
                      + sc.shape[-1:])


def quantize_weight(w: torch.Tensor, base_ndim: int) -> dict:
    """Symmetric int8; scale per (stack dims..., last axis): the absolute
    maximum over the other base axes, floored at 1e-8, over 127 (a true
    float32 division, as the reference's eager ``quantize_params``), then
    ``round`` (half to even, as ``jnp.round``) and a clip to ±127."""
    lead = w.dim() - base_ndim
    red = tuple(range(lead, w.dim() - 1))
    w32 = w.float()
    absmax = w32.abs().amax(dim=red) if red else w32.abs()
    sc = absmax.clamp_min(1e-8) / 127.0
    q = torch.round(w32 / _broadcast_scale(sc, w.dim())).clamp(-127, 127)
    return {"q8": q.to(torch.int8), "sc": sc}


def dequantize_weight(leaf, dtype=torch.bfloat16):
    """``q8 * sc`` in float32, rounded once to ``dtype``: one kernel that
    reads the int8 values and writes ``dtype`` (no float32 copy of the
    weight), with the reference's bits.  A leaf that is not quantized
    comes back as it is.

    A leaf placed on a mesh (DTensor ``q8`` and ``sc``, as
    ``placement_bridge.param_spec`` places them) is dequantized shard by
    shard: the rank's ``q8`` times its ``sc``, wrapped as a DTensor with
    ``q8``'s placements.  This is exact and needs no collective: ``sc``
    takes its weight's last-axis spec, so a rank's scale shard covers the
    last axis of its ``q8`` shard, and every other axis of the weight is
    reduced over in the absmax, so the scale is the same on every shard
    of those axes."""
    if not is_quantized(leaf):
        return leaf
    q8, sc = leaf["q8"], leaf["sc"]
    if is_dtensor(q8):
        out = dequantize_weight({"q8": q8.to_local(), "sc": local(sc)},
                                dtype)
        return from_local(out, Sharding(q8.device_mesh,
                                        tuple(q8.placements)), q8.shape)
    out = torch.empty(q8.shape, dtype=dtype, device=q8.device)
    return torch.mul(q8, _broadcast_scale(sc, q8.dim()), out=out)


def wt(p: dict, name: str, dtype=torch.bfloat16):
    """Weight accessor of the model code: ``p[name]`` dequantized to
    ``dtype``, or cast to it when not quantized (the port's layers cast
    every weight to the activation dtype)."""
    leaf = p[name]
    if is_quantized(leaf):
        return dequantize_weight(leaf, dtype)
    return leaf.to(dtype)


def quantize_params(params) -> Any:
    """Quantize every QUANT_NAMES leaf of a param tree (floating, at least
    2-D); inside a ``moe`` dict the expert stacks ``w_*`` have base rank 3
    ((E, D, F) experts).  Other leaves are kept, not copied."""
    def visit(tree, parent=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k in QUANT_NAMES and isinstance(v, torch.Tensor) \
                        and v.dim() >= 2 and v.is_floating_point():
                    base = _BASE_NDIM[k]
                    if parent == "moe" and k.startswith("w_"):
                        base = 3                      # (E, D, F) experts
                    out[k] = quantize_weight(v, base)
                else:
                    out[k] = visit(v, parent=k)
            return out
        return tree
    return visit(params)
