"""Decoder layers: RMSNorm and LayerNorm, RoPE, GQA attention (causal or
sliding-window, plain or chunked flash-style) with a per-slot, paged or ring KV
cache (in the working dtype or int8), gated cross-attention over image K/V
(llama-3.2-vision), SwiGLU and GELU MLPs, embeddings (tied or not) and the
training loss (``cross_entropy``) — counterpart of the JAX package's
``models/layers.py``, for the branches the llama, glm4 (QKV bias, partial
RoPE), qwen1.5, mixtral, musicgen (LayerNorm, GELU with biases) and VLM
families take.

Functions take plain tensors and nested dicts of parameters in the
reference's layouts (``wq`` (D,Hp,dh), ``wk``/``wv`` (D,Kp,dh), ``wo``
(Hp,dh,D), biases ``bq`` (Hp,dh), ``bk``/``bv`` (Kp,dh)); each matmul
weight may be int8 (``quantization.quantize_params``) and is read through
``quantization.wt``.  Caches are updated in place.

Head layout for tensor parallelism at degree ``tp`` (``head_dims``):
  Hp  — query heads zero-padded to a multiple of ``tp``,
  KvE — KV heads expanded (zero-pad, then ``rep``-fold repeat) to
        ``max(pad(K), tp)``; the repeat happens on activations, so the
        weights keep ``Kp`` rows and their gradients stay exact.
The KV cache stores the expanded layout, so its head axis shards as the
query heads do: each device holds the KV of the heads it serves.

Sharding is expressed only through a ``partitioning.Partitioner``
(``part``, a no-op ``NULL`` by default): its ``constrain`` points are the
reference's, and under a mesh they redistribute DTensor intermediates.
Attention itself runs on each rank's shard (``partitioning.local``):
heads and batch rows are independent there, so no collective is needed.
Under the long-decode rules (``make_partitioner(seq_over_data=True)``) a
cache's sequence — a ring's slots — is sharded over "data" as well: each
rank writes the positions it owns, attends over them alone and the ranks
merge their partial softmaxes (``partitioning.SeqShard``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.partitioning import (EMPTY_LSE, NULL, Partitioner,
                                             Sharding, batch_axes,
                                             from_local, gather_fsdp,
                                             is_dtensor, like, local,
                                             local_extent, local_range,
                                             local_shards, mesh_group,
                                             seq_shard, sum_over,
                                             use_placements, whole)
from repro_torch.models.quantization import is_quantized, wt
# attention_scores and chunked_attention stay importable from here, beside
# the rest of the reference's layers
from repro_torch.kernels.attention_plain import (  # noqa: F401
    attend as plain_attend, attention_scores, causal_mask, chunked_attention)


# ---------------------------------------------------------------------------
# Derived head dims
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadDims:
    H: int      # logical query heads
    K: int      # logical kv heads
    Hp: int     # padded query heads
    Kp: int     # zero-padded kv heads (before repeat)
    rep: int    # activation repeat factor
    KvE: int    # expanded kv heads stored in the cache = Kp * rep
    dh: int

    @property
    def groups(self) -> int:
        return self.Hp // self.KvE


def head_dims(cfg: ModelConfig, tp: int = 1) -> HeadDims:
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if H == 0:
        return HeadDims(0, 0, 0, 0, 1, 0, dh)
    Hp = -(-H // tp) * tp
    if K >= tp:
        Kp = -(-K // tp) * tp
        rep = 1
    else:
        # tp > K: repeat each kv head so every device holds exactly the KV
        # head(s) its local query heads attend to
        Kp = K
        rep = tp // K if tp % K == 0 else tp
    KvE = Kp * rep
    if Hp % KvE:
        raise ValueError(f"GQA layout mismatch H={H} K={K} tp={tp}")
    return HeadDims(H, K, Hp, Kp, rep, KvE, dh)


# ---------------------------------------------------------------------------
# Initializers (the reference's scales; random bits come from torch)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, shape, dtype,
               device) -> torch.Tensor:
    return normal_init(gen, shape, 1.0 / math.sqrt(d_in), dtype, device)


def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def zero_pad_heads(w: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    """Zero-pad a head axis up to ``to`` rows (padded heads never influence
    outputs: their o-projection rows are zero as well)."""
    pad = to - w.shape[axis]
    if pad == 0:
        return w
    shape = list(w.shape)
    shape[axis] = pad
    return torch.cat([w, w.new_zeros(shape)], dim=axis)


def init_attention(gen: torch.Generator, cfg: ModelConfig, hd: HeadDims,
                   lead: tuple, dtype, device, *, cross: bool = False
                   ) -> dict:
    """Attention weights stacked over ``lead`` (the layer axes): ``wq``
    (D, H, dh), ``wk``/``wv`` (D, K, dh), ``wo`` (H, dh, D) drawn in that
    order at the reference's scales, then zero-padded to ``Hp``/``Kp``
    head rows; ``qkv_bias`` configs add zero ``bq``/``bk``/``bv``, and a
    gated cross-attention layer (llama-3.2-vision) a zero ``gate`` per
    layer, as the reference initializes them."""
    D = cfg.d_model
    n = len(lead)

    def dense(d_in, shape, axis, to):
        w = dense_init(gen, d_in, lead + shape, dtype, device)
        return zero_pad_heads(w, n + axis, to)

    def zeros(shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    p = {"wq": dense(D, (D, hd.H, hd.dh), 1, hd.Hp),
         "wk": dense(D, (D, hd.K, hd.dh), 1, hd.Kp),
         "wv": dense(D, (D, hd.K, hd.dh), 1, hd.Kp),
         "wo": dense(hd.H * hd.dh, (hd.H, hd.dh, D), 0, hd.Hp)}
    if cfg.qkv_bias:
        p["bq"] = zeros((hd.Hp, hd.dh))
        p["bk"] = zeros((hd.Kp, hd.dh))
        p["bv"] = zeros((hd.Kp, hd.dh))
    if cross:
        p["gate"] = zeros(())
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead: tuple, dtype,
             device) -> dict:
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or GELU (``w_up``, zero
    ``b_up``, ``w_down``, zero ``b_down``) weights stacked over ``lead``."""
    D, F_ = cfg.d_model, cfg.d_ff

    def dense(d_in, shape):
        return dense_init(gen, d_in, lead + shape, dtype, device)

    if cfg.mlp_type == "swiglu":
        return {"w_gate": dense(D, (D, F_)), "w_up": dense(D, (D, F_)),
                "w_down": dense(F_, (F_, D))}
    return {"w_up": dense(D, (D, F_)),
            "b_up": torch.zeros(lead + (F_,), dtype=dtype, device=device),
            "w_down": dense(F_, (F_, D)),
            "b_down": torch.zeros(lead + (D,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float):
    """LayerNorm over the last axis in float32 (population variance), then
    scale and bias in float32, cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: dict, name: str, x):
    """The config's norm of ``x`` with scale ``p[name]`` (LayerNorm: and
    bias ``p[name + "_b"]``)."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p[name], p[name + "_b"], cfg.norm_eps)
    return rms_norm(x, p[name], cfg.norm_eps)


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: (B, S, n_heads, dh); positions: (B, S) int. Rotates the first
    ``fraction`` of the head dim, rounded down to an even count (GLM-4
    rotates half), and passes the rest through."""
    dh = x.shape[-1]
    dh_rot = int(dh * fraction)
    dh_rot -= dh_rot % 2
    freqs = 1.0 / (theta ** (torch.arange(0, dh_rot, 2, dtype=torch.float32,
                                          device=x.device) / dh_rot))
    ang = positions[..., None].float() * freqs          # (B, S, dh_rot/2)
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    xr = x[..., :dh_rot].float()
    x1, x2 = xr[..., : dh_rot // 2], xr[..., dh_rot // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
    if dh_rot == dh:
        return rotated
    return torch.cat([rotated, x[..., dh_rot:]], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, per-slot linear or paged cache, fp or int8)
# ---------------------------------------------------------------------------


def repeat_kv(t, rep: int):
    """Each KV head of ``t`` (..., Kp, dh) repeated ``rep`` times in place
    (``jnp.repeat`` along the head axis): expanded row ``o·rep + r`` is
    replica r of head o."""
    if rep <= 1:
        return t
    shape = t.shape
    return t.unsqueeze(-2).expand(shape[:-1] + (rep, shape[-1])).reshape(
        shape[:-2] + (shape[-2] * rep, shape[-1]))


def qkv_project(cfg: ModelConfig, p: dict, hd: HeadDims, x, positions, *,
                part=NULL):
    """Returns q (B,S,Hp,dh) and k, v (B,S,KvE,dh); ``qkv_bias`` configs
    add ``bq`` (Hp,dh) and ``bk``/``bv`` (Kp,dh) before RoPE, and
    ``rep`` > 1 repeats K and V on the activations after it."""
    q = torch.einsum("bsd,dhk->bshk", x, wt(p, "wq", x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, wt(p, "wk", x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, wt(p, "wv", x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    k, v = repeat_kv(k, hd.rep), repeat_kv(v, hd.rep)
    q = part.constrain(q, ("batch", "seq", "heads", None))
    k = part.constrain(k, ("batch", "seq", "kv_heads", None))
    v = part.constrain(v, ("batch", "seq", "kv_heads", None))
    return q, k, v


def _decode_lengths(cache_pos, B: int, device):
    """Valid-cache-length vector for the flash-decode kernel: the current
    token writes at ``cache_pos`` and attends positions <= its own, so the
    kernel's per-row length is ``pos + 1`` (a scalar start broadcasts)."""
    if isinstance(cache_pos, torch.Tensor):
        return cache_pos.to(torch.int32) + 1
    return torch.full((B,), cache_pos + 1, dtype=torch.int32, device=device)


def _head_rows_or_identity(head_rows, head_inv, n_rows: int, device):
    """Gather/scatter maps for the resident-slice kernel; identity (dense
    grid over all rows, no scatter) when no placement maps are given."""
    if head_rows is None:
        return torch.arange(n_rows, dtype=torch.int32, device=device), None
    return head_rows, head_inv


def _project_out(p: dict, out, *, gate=None, part=NULL):
    """Attention output tail: the wo projection, times ``tanh(gate)`` for
    the VLM's gated cross-attention, constrained to the residual layout
    (under a mesh: the reduction of the head-sharded contraction)."""
    out = torch.einsum("bshk,hkd->bsd", out, wt(p, "wo", out.dtype))
    if gate is not None:
        out = out * torch.tanh(gate).to(out.dtype)
    return part.constrain(out, ("batch", "res_seq", "d_model"))


# XLA rewrites the reference's ``amax / 127.0`` into a multiply by
# float32(1/127) under ``jit`` (it keeps ``x / sc`` a true division), and a
# literal division gives another scale in ~4 % of rows (1 ulp).  So the
# scale multiplies by the float32 reciprocal, which reproduces the jitted
# reference bit for bit.
_INV_127 = 1.0 / 127.0


def _q8(t):
    """Per-(token, head) int8 quantization over dh: (values int8, scales
    float32) — one definition shared by the dense and paged int8 cache
    branches so their stored values cannot diverge.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x = t.float()
    sc = x.abs().amax(dim=-1).clamp_min(1e-8) * _INV_127
    qq = torch.round(x / sc[..., None]).clamp(-127, 127).to(torch.int8)
    return qq, sc


def _write_cache(cache: dict, new: dict, cache_pos, seq=None):
    """Store this call's K/V (and, for int8 caches, their scales: ``new``
    maps each cache buffer's name to its (B, S, ...) values) in place.  A
    (B,) ``cache_pos`` (continuous batching, S == 1) writes row b at its
    own position; a retired slot's position sits clamped at T, and its
    write is dropped (the reference's ``mode="drop"`` scatter: each row
    writes only its own cache row, so writing the old value back at a
    clamped index collides with no live write).  An int ``cache_pos``
    writes S positions from there for every row (prefill).  ``seq`` (a
    ``partitioning.SeqShard``): the buffers hold this rank's positions
    ``[lo, lo + n)`` of ``total``, and only those of the write land."""
    B, S = new["k"].shape[0], new["k"].shape[1]
    T = cache["k"].shape[1] if seq is None else seq.total
    lo, n = (0, T) if seq is None else (seq.lo, seq.n)
    if isinstance(cache_pos, torch.Tensor):
        if cache_pos.shape != (B,) or S != 1:
            raise ValueError("per-slot cache writes take a (B,) position "
                             "vector and one token per row")
        if n == 0:
            return
        rows = torch.arange(B, device=cache_pos.device)
        at = cache_pos.long() - lo
        cp = at.clamp(0, n - 1)
        for name, t in new.items():
            buf = cache[name]
            keep = ((at >= 0) & (at < n)).view(
                (B,) + (1,) * (buf.dim() - 2))
            buf[rows, cp] = torch.where(keep, t[:, 0], buf[rows, cp])
        return
    if not 0 <= cache_pos <= T - S:
        raise ValueError(f"cache write [{cache_pos}, {cache_pos + S}) "
                         f"outside a cache of {T} positions")
    a, c = (cache_pos, S) if seq is None else seq.span(cache_pos, S)
    for name, t in new.items():
        cache[name][:, a - lo:a - lo + c] = t[:, a - cache_pos:
                                              a - cache_pos + c]


def _dequant(cache: dict, dtype):
    """The cache as attention reads it: int8 values times their scales
    (the reference attends the dequantized cache, prefill included)."""
    if "k_sc" not in cache:
        return cache["k"], cache["v"]
    return tuple((cache[n].float() * cache[n + "_sc"][..., None]).to(dtype)
                 for n in ("k", "v"))


def _paged_write(cache: dict, new: dict, positions, page_map, write_valid):
    """Scatter this call's K/V (and scales) into the page store through the
    page map, in place.  The store ``(n_pages + 1, P, ...)`` holds one
    sink page past the pool that the allocator never hands out and no
    page map names: writes the reference drops — an unmapped (-1) page,
    or a ``write_valid == False`` chunk tail — go there instead.  Torch has
    no ``mode="drop"`` scatter, and writing an old value back at a clamped
    index could collide with a live write of the same call, whose order
    ``index_put_`` leaves undefined; writes that collide in the sink are
    never read.  All on the device: no host sync."""
    n_store, P = cache["k"].shape[0], cache["k"].shape[1]
    sink = (n_store - 1) * P
    pos = positions.long()                                     # (B, S)
    lpage = (pos // P).clamp(0, page_map.shape[1] - 1)
    phys = page_map.long().gather(1, lpage)
    w_idx = torch.where(phys >= 0, phys * P + pos % P, sink)
    if write_valid is not None:
        w_idx = torch.where(write_valid, w_idx, sink)
    w_idx = w_idx.reshape(-1)
    for name, t in new.items():
        flat = cache[name].view((n_store * P,) + cache[name].shape[2:])
        flat[w_idx] = t.reshape((-1,) + t.shape[2:])


def _paged_gather(cache: dict, page_map, dtype):
    """The (B, np * P, KvE, dh) cache each row holds, in logical order
    (dequantized for int8).  Unmapped pages read page 0; the causal mask
    hides them."""
    n_store, P = cache["k"].shape[0], cache["k"].shape[1]
    B, n_log = page_map.shape
    idx = (page_map.clamp_min(0).long()[:, :, None] * P
           + torch.arange(P, device=page_map.device)).reshape(B, n_log * P)

    def gather(name):
        buf = cache[name]
        return buf.view((n_store * P,) + buf.shape[2:])[idx]

    return _dequant({n: gather(n) for n in cache}, dtype)


EMPTY_SLOT = -2 ** 30   # ring slot position that never passes a window


def _over_shard(seq, q, partial):
    """Attention over a sequence-sharded cache from this rank's share:
    ``partial()`` gives the float32 output and log-sum-exp over the rank's
    positions, merged with the other ranks' (``SeqShard.merge``) and cast
    to q's dtype once; a rank holding no position contributes zeros that
    weigh nothing."""
    if seq.n == 0:
        out = q.new_zeros(q.shape, dtype=torch.float32)
        lse = torch.full(q.shape[:3], EMPTY_LSE, device=q.device)
    else:
        out, lse = partial()
    return seq.merge(out, lse, q.dtype)


def _ring_attention(q, k, v, positions, cache: dict, cache_pos,
                    window: int, attend, finish, use_kernel: bool, head_rows,
                    head_inv, seq=None):
    """Sliding-window attention over a ring cache {"k","v"} (B, window,
    KvE, dh) whose "pos" (window,) holds the absolute position of each
    slot, updated in place; ``finish`` projects the attention output out.
    On a mesh every tensor is the rank's local one: its batch rows and
    heads of q, k, v and the ring, and its copy of the replicated "pos",
    which every rank writes alike.  ``seq`` (the long-decode rules): the
    rank's "k"/"v" hold slots ``[lo, lo + n)`` of the window; a prefill
    folds into those slots, a decode step writes its slot on the rank
    owning it, and attention runs over the rank's slots (validity from
    the whole window) and merges across the ranks.

    Prefill (S > 1, positions ``cache_pos + arange(S)``, lock-step): attend
    over the in-flight K/V under the window mask — queries and keys share
    their positions, so with ``use_kernel`` this is the flash kernel's
    aligned windowed attention — then fold the last ``window`` tokens into
    the ring: slot ``t % window`` takes position t, slots no token reached
    hold ``EMPTY_SLOT``.  Decode (S == 1, an int ``cache_pos``): write slot
    ``cache_pos % window`` and its position, then attend over the ring by
    position (the buffer is never rotated), through the ring kernel when
    ``use_kernel``."""
    B, S = q.shape[0], q.shape[1]
    if isinstance(cache_pos, torch.Tensor):
        raise ValueError("a ring cache takes one int position for the "
                         "whole batch (lock-step decode)")
    if S > 1:
        out = attend(k, v, positions, causal_mask(positions, positions,
                                                  window), flash=use_kernel)
        if S >= window:
            tail_k, tail_v = k[:, -window:], v[:, -window:]
            tail_pos = positions[0, -window:].to(torch.int32)
        else:
            pad = window - S
            tail_k = F.pad(k, (0, 0, 0, 0, 0, pad))
            tail_v = F.pad(v, (0, 0, 0, 0, 0, pad))
            tail_pos = F.pad(positions[0].to(torch.int32), (0, pad),
                             value=EMPTY_SLOT)
        # the first tail position, known on the host: no device sync
        shift = (cache_pos + max(S - window, 0)) % window
        lo, n = (0, window) if seq is None else (seq.lo, seq.n)
        cache["k"].copy_(torch.roll(tail_k, shift, dims=1)[:, lo:lo + n])
        cache["v"].copy_(torch.roll(tail_v, shift, dims=1)[:, lo:lo + n])
        cache["pos"].copy_(torch.roll(tail_pos, shift))
        return finish(out)
    idx = cache_pos % window
    if seq is None or seq.owns(idx):
        at = idx if seq is None else idx - seq.lo
        cache["k"][:, at] = k[:, 0]
        cache["v"][:, at] = v[:, 0]
    # a fill, not an item assignment: assigning a Python int copies it
    # from host memory, a host sync on every decode step
    cache["pos"][idx:idx + 1].fill_(cache_pos)
    if use_kernel:
        rows, inv = _head_rows_or_identity(head_rows, head_inv, q.shape[2],
                                           q.device)
        lengths = _decode_lengths(cache_pos, B, q.device)
        if seq is None:
            return finish(ops.decode_attention_ring_bshd(
                q, cache["k"], cache["v"], lengths, cache["pos"],
                window=window, rows=rows, inv_rows=inv))
        return finish(_over_shard(
            seq, q, lambda: ops.decode_attention_ring_bshd(
                q, cache["k"], cache["v"], lengths,
                cache["pos"][seq.lo:seq.lo + seq.n], window=window,
                rows=rows, inv_rows=inv, return_lse=True)))
    if seq is None:
        kv_pos = cache["pos"][None, :].expand(B, window)
        out = attend(cache["k"], cache["v"], kv_pos,
                     causal_mask(positions, kv_pos, window))
        return finish(out)
    kv_pos = cache["pos"][None, seq.lo:seq.lo + seq.n].expand(B, seq.n)
    return finish(_over_shard(seq, q, lambda: attention_scores(
        q, cache["k"], cache["v"], causal_mask(positions, kv_pos, window),
        return_lse=True)))


def _seq_attention(q, k, v, positions, cache: dict, cache_pos, seq,
                   window: int, attend, finish, use_kernel: bool, head_rows,
                   head_inv):
    """Attention over a linear cache whose sequence is sharded over the
    mesh's data axis (``seq``: this rank holds positions ``[lo, lo + n)``
    in the rank's shard of ``cache``).  The write lands on the positions
    the rank owns (``_write_cache``).  A prefill from position 0 attends
    its in-flight K/V — dequantized for int8, the function the unsharded
    path computes over the cache's first S rows — through flash with
    ``use_kernel``, on every rank alike.  Any other call attends over the
    rank's positions and merges across the ranks (``_over_shard``): an
    S == 1 decode through the resident kernel's LSE output with
    ``use_kernel`` (no window, not int8), else the plain attention's."""
    B, S = q.shape[0], q.shape[1]
    quant = "k_sc" in cache
    new = {"k": k, "v": v}
    if quant:
        (new["k"], new["k_sc"]), (new["v"], new["v_sc"]) = _q8(k), _q8(v)
    _write_cache(cache, new, cache_pos, seq)
    if S > 1 and not isinstance(cache_pos, torch.Tensor) and cache_pos == 0:
        ck, cv = _dequant(new, q.dtype)
        return finish(attend(ck, cv, positions,
                             causal_mask(positions, positions, window),
                             flash=use_kernel))
    if use_kernel and S == 1 and not window:
        if quant:
            raise ValueError("an int8 cache's decode kernel takes no "
                             "sequence shard (ROADMAP Queue 1): serve the "
                             "long-decode rules from a bf16 cache")
        rows, inv = _head_rows_or_identity(head_rows, head_inv, q.shape[2],
                                           q.device)
        lengths = seq.local_lengths(_decode_lengths(cache_pos, B, q.device))
        return finish(_over_shard(
            seq, q, lambda: ops.decode_attention_resident_bshd(
                q, cache["k"], cache["v"], lengths, rows, inv_rows=inv,
                return_lse=True)))
    kv_pos = (seq.lo + torch.arange(seq.n, device=q.device))[None].expand(
        B, seq.n)
    return finish(_over_shard(seq, q, lambda: attention_scores(
        q, *_dequant(cache, q.dtype), causal_mask(positions, kv_pos, window),
        return_lse=True)))


def self_attention_block(cfg: ModelConfig, p: dict, hd: HeadDims, x,
                         positions, *, cache=None, cache_pos=None,
                         window: int = 0, use_kernel: bool = False,
                         head_rows=None, head_inv=None, page_map=None,
                         write_valid=None, part=NULL):
    """Causal (``window`` > 0: sliding-window) self-attention with an
    optional linear, paged or ring KV cache.

    cache: dict {"k","v"} of (B, T, KvE, dh) buffers, written in place;
      int8 caches (``kv_quant``) hold int8 values plus float32
      per-(token, head) scales {"k_sc","v_sc"} (B, T, KvE), and attention
      reads the dequantized cache.  A sliding-window arch whose cache
      length is the window keeps a ring instead ({"k","v","pos"}, see
      ``_ring_attention``).
    cache_pos: an int start position (prefill: S tokens land at
      [cache_pos, cache_pos + S); lock-step decode), or a (B,) int32 tensor
      for slot-level continuous batching (S == 1): row b writes its new K/V
      at its own position and the causal mask is taken per row.  None for
      a paged prefill chunk.
    page_map: (B, np) int32 — the cache is then a page store
      (n_pages + 1, P, KvE, dh) (scales (n_pages + 1, P, KvE)) shared by
      every slot; row b's logical page i is physical page
      ``page_map[b, i]`` (-1 = unmapped: writes there drop, reads clamp to
      page 0 and are masked).  ``write_valid`` (B, S) bool marks which of
      this call's tokens store K/V (chunked prefill tails do not).
    use_kernel: S == 1 decode runs the hand-written flash-decode kernel of
      the cache's kind (``ops.decode_attention_*_bshd``) over
      ``head_rows`` — the physical q-head rows in slot-grouped placement
      order — and scatters back with ``head_inv``; None runs the identity
      grid.  As in the reference, a linear cache under a window (a
      sliding-window arch served below its window) keeps the plain path.
      The CUDA kernels have no tiling constraint, so every cache length
      dispatches to them.  A prefill (S > 1) whose queries and keys sit at
      the same positions from the first key — the cacheless forward, a
      ring prefill over the in-flight K/V, a linear-cache prefill from
      position 0 — runs the flash attention kernel
      (``ops.flash_attention_bshd``), which computes the plain path's
      function.
    Otherwise attention over a KV extent of 2048 or more (a multiple of
    1024) with more than one query runs ``chunked_attention`` — the
    reference's ``attend`` dispatch, which the flash kernel's plain
    version repeats on the CPU.
    part: the intermediates' layout (``partitioning``).  With DTensor
      parameters (a dense or MoE model on a mesh) the projections run through
      DTensor and attention on each rank's shard: its batch rows and the
      heads it holds (``partitioning.local``), with the cache a DTensor of
      the reference's decode-state layout whose local shard — batch rows
      over "data", expanded KV heads over "model" — is written in place.
      ``head_rows``/``head_inv`` are then the rank's own maps
      (``partitioning.local_head_rows``), positions, ``cache_pos`` and the
      page map are cut to the rank's batch rows, and a page store is the
      rank's own pool, its page axis over the batch axes (one pool, with
      its own sink page, for each batch rank): the rank's rows of the page
      map name pages of that pool.  A paged prefill chunk of one row on
      several batch ranks runs on every rank, writes only into the pool of
      the rank holding the row (the others' table rows are unmapped, so
      their writes drop into their sinks), and takes that rank's
      attention output (``Partitioner.from_owner``).  Under the long-decode
      rules (``make_partitioner(seq_over_data=True)``) the batch stays
      whole and a linear cache's sequence — a ring's slots — lies over
      "data" too (``partitioning.seq_shard``): the rank writes the
      positions it owns, a prefill from position 0 attends its in-flight
      K/V, and any other call attends over the rank's positions (the
      kernels' LSE output, or the plain attention's) and merges across
      "data" (``_seq_attention``, ``_ring_attention``).  A paged cache
      takes no sequence shard.
    Returns (out, cache).
    """
    q, k, v = qkv_project(cfg, p, hd, x, positions, part=part)
    layout, seq = q, None
    if is_dtensor(q):
        # q, k, v shard batch rows and heads, positions batch rows
        # (``rules_tp``); a rank's query heads and their KV heads sit on
        # that rank (the expanded layout), so attention of the shards —
        # the kernels' or the plain path's, over the rank's cache shard —
        # is that shard of the whole one, with no collective
        q, k, v = local(q), local(k), local(v)
        positions = _rows_of(part, positions, ("batch", "seq"))
        if isinstance(cache_pos, torch.Tensor):
            cache_pos = _rows_of(part, cache_pos, ("batch",))
        if page_map is not None:
            page_map = _rows_of(part, page_map, ("batch", None))
            if write_valid is not None:
                write_valid = _rows_of(part, write_valid, ("batch", "seq"))
        if cache is not None:
            if page_map is None:
                seq = seq_shard(part, cache["k"])
            elif part.rules.get("cache_seq"):
                raise ValueError("a paged cache takes no sequence shard "
                                 "(ROADMAP Queue 1): serve the long-decode "
                                 "rules from a linear or ring cache")
            cache = _cache_shards(cache, part, paged=page_map is not None)
        if head_rows is not None and head_rows.shape[-1] != q.shape[2]:
            raise ValueError(
                f"a sharded decode takes the rank's own row maps of "
                f"{q.shape[2]} heads (partitioning.local_head_rows); got "
                f"{head_rows.shape[-1]}")
    B, S = q.shape[0], q.shape[1]

    def finish(out):
        """The wo projection of this rank's attention output (under a
        mesh: the reduction of the head-sharded contraction)."""
        return _project_out(p, like(out, layout), part=part)

    def attend(kk, vv, kv_pos, mask, *, flash: bool = False, qq=None):
        """The reference's dispatch (chunked when the KV extent is long,
        else plain) — or, with ``flash`` and more than one query, the flash
        kernel, for calls whose queries and keys share their positions
        from the first key (the causal mask aligned at the top left).
        ``qq``: the query heads of ``kk``'s KV heads (default all)."""
        qq = q if qq is None else qq
        if flash and S > 1:
            return ops.flash_attention_bshd(qq, kk, vv, causal=True,
                                            window=window)
        return plain_attend(qq, kk, vv, positions, kv_pos, mask,
                            window=window)

    if cache is None:
        out = attend(k, v, positions, causal_mask(positions, positions,
                                                  window), flash=use_kernel)
        return finish(out), None
    ring = page_map is None and window and (
        cache["k"].shape[1] if seq is None else seq.total) == window
    if ring:
        return _ring_attention(q, k, v, positions, cache, cache_pos,
                               window, attend, finish, use_kernel, head_rows,
                               head_inv, seq), cache
    if seq is not None:
        return _seq_attention(q, k, v, positions, cache, cache_pos, seq,
                              window, attend, finish, use_kernel, head_rows,
                              head_inv), cache
    quant = "k_sc" in cache
    new = {"k": k, "v": v}
    if quant:
        (new["k"], new["k_sc"]), (new["v"], new["v_sc"]) = _q8(k), _q8(v)
    kernel = use_kernel and S == 1 and cache_pos is not None and not window
    if kernel:
        rows, inv = _head_rows_or_identity(head_rows, head_inv, q.shape[2],
                                           q.device)
        lengths = _decode_lengths(cache_pos, B, q.device)
    if page_map is not None:
        _paged_write(cache, new, positions, page_map, write_valid)
        if kernel:
            # the kernels take the pool proper, without the sink page
            pool = {n: t[:-1] for n, t in cache.items()}
            gmap = page_map.clamp_min(0)
            if quant:
                out = ops.decode_attention_int8_paged_bshd(
                    q, pool["k"], pool["k_sc"], pool["v"], pool["v_sc"],
                    lengths, gmap, rows, inv_rows=inv)
            else:
                out = ops.decode_attention_paged_bshd(
                    q, pool["k"], pool["v"], lengths, gmap, rows,
                    inv_rows=inv)
            return finish(out), cache
        if page_map.shape[0] > 1:
            # a plain decode step: several rows' page tables, gathered into
            # one dense copy, can outgrow the pool itself, so each KV head's
            # pages are gathered and attended alone
            T = page_map.shape[1] * cache["k"].shape[1]
            kv_pos = torch.arange(T, device=q.device)[None, :].expand(B, T)
            mask = causal_mask(positions, kv_pos, window)
            KvE = cache["k"].shape[2]
            G = q.shape[2] // KvE
            out = torch.cat([attend(
                *_paged_gather({n: t[:, :, e:e + 1]
                                for n, t in cache.items()},
                               page_map, q.dtype), kv_pos, mask,
                qq=q[:, :, e * G:(e + 1) * G]) for e in range(KvE)], dim=2)
            return finish(part.from_owner(out)), cache
        # one row's pages (a prefill chunk) span at most one sequence
        ck, cv = _paged_gather(cache, page_map, q.dtype)
    else:
        _write_cache(cache, new, cache_pos)
        if use_kernel and S > 1 and not isinstance(cache_pos, torch.Tensor) \
                and cache_pos == 0:
            # a prefill from position 0: keys at or past S are masked for
            # every query, so attending the cache's first S rows
            # (dequantized for int8) equals attending the whole cache.  The
            # paged chunk prefill above keeps the plain path: its later
            # chunks start past position 0 over keys from position 0, which
            # the top-left-aligned kernel does not take.
            ck, cv = _dequant({n: t[:, :S] for n, t in cache.items()},
                              q.dtype)
            return finish(attend(ck, cv, None, None, flash=True)), cache
        if kernel:
            if quant:
                out = ops.decode_attention_int8_resident_bshd(
                    q, cache["k"], cache["k_sc"], cache["v"], cache["v_sc"],
                    lengths, rows, inv_rows=inv)
            else:
                out = ops.decode_attention_resident_bshd(
                    q, cache["k"], cache["v"], lengths, rows, inv_rows=inv)
            return finish(out), cache
        ck, cv = _dequant(cache, q.dtype)
    T = ck.shape[1]
    kv_pos = torch.arange(T, device=q.device)[None, :].expand(B, T)
    out = attend(ck, cv, kv_pos, causal_mask(positions, kv_pos, window))
    if page_map is not None:
        out = part.from_owner(out)
    return finish(out), cache


def _rows_of(part, t, axes):
    """This rank's batch rows of ``t``: a DTensor's shard, or a plain
    tensor (the same on every rank) cut as ``axes`` place it."""
    return local(part.shard(t, axes))


# the reference's layout constraints on an updated cache: a linear cache
# (B, T, KvE, dh) or a ring's values (B, window, KvE, dh) and int8 scales
# (B, T, KvE) shard batch rows and heads, a page store (pages, P, KvE, dh)
# its pages over the batch axes and its heads; a ring's slot positions
# (window,) are replicated
_CACHE_AXES = {False: ("batch", "cache_seq", "kv_heads", None),
               True: ("batch", None, "kv_heads", None)}


def _cache_shards(cache: dict, part, *, paged: bool) -> dict:
    """The rank's shards of a layer's DTensor cache buffers, each held to
    the reference's cache layout (``partitioning.local_shards``).  A page
    store's pages lie over the batch axes whatever the call's batch rule
    (a one-row prefill keeps its batch whole there)."""
    if paged:
        part = Partitioner(part.mesh, dict(part.rules,
                                           batch=batch_axes(part.mesh)))
    return local_shards(cache, part, {
        name: () if name == "pos" else _CACHE_AXES[paged][:t.dim()]
        for name, t in cache.items()})


# the reference's layout of the image K/V (B, I, KvE, dh): batch rows over
# the data axes, expanded KV heads over "model"
IMG_KV_AXES = ("batch", "img_seq", "kv_heads", None)


def project_kv(cfg: ModelConfig, p: dict, hd: HeadDims, kv_x, *,
               rows: tuple = None, heads: tuple = None, fsdp=(),
               partial=()) -> dict:
    """Cross-attention K/V {"k", "v"} (B, I, KvE, dh) of the image
    embeddings ``kv_x`` (B, I, D): no RoPE, ``bk``/``bv`` for
    ``qkv_bias`` configs, each KV head repeated ``rep`` times.

    ``rows`` and ``heads`` ((start, count); the whole axis by default)
    give one rank's shard of a mesh's image K/V (``IMG_KV_AXES``): batch
    rows of ``kv_x`` and expanded KV rows of KvE, projected on local
    tensors from the rank's shards of ``wk``/``wv`` (and ``bk``/``bv``),
    whose KV head axis holds the rows ``local_range`` gives (all of them
    where the weights are replicated).  Expanded row e is replica
    ``e % rep`` of KV head ``e // rep``, so the shard needs no other
    rank's weights and no rank computes the whole image K/V.  ``kv_x``
    may be a DTensor placed with those batch rows.

    ``fsdp`` and ``partial`` (``partitioning.gather_fsdp``): the storage
    axes the weights are gathered from on use, and the mesh dimensions
    over which the shard is one part of the whole projection (its batch
    rows, its heads): the weights' gradients are partial sums there."""
    x = local(kv_x) if is_dtensor(kv_x) else kv_x
    rows = rows or (0, x.shape[0])
    lo, n = heads or (0, hd.KvE)
    if not is_dtensor(kv_x):
        x = x.narrow(0, *rows)
    if x.shape[0] != rows[1]:
        raise ValueError(f"the image embeddings' local rows {x.shape[0]} "
                         f"are not the image K/V shard's {rows[1]}")
    # the KV heads whose replicas cover the expanded rows [lo, lo + n)
    h0, h1 = lo // hd.rep, -(-(lo + n) // hd.rep)
    ws = {name: wt(p, "w" + name, x.dtype) for name in ("k", "v")}
    # the KV head rows the rank holds once the storage axes are gathered
    w_lo, w_n = _used_range(ws["k"], ws["k"].dim() - 2, fsdp)
    if n and not w_lo <= h0 < h1 <= w_lo + w_n:
        raise ValueError(f"this rank's KV weight rows do not hold the "
                         f"expanded rows [{lo}, {lo + n})")
    out = {}
    for name in ("k", "v"):
        w = gather_fsdp(ws[name], fsdp, partial).narrow(-2, h0 - w_lo,
                                                         h1 - h0)
        t = torch.einsum("bsd,dhk->bshk", x, w)
        if cfg.qkv_bias:
            b = gather_fsdp(p["b" + name], fsdp, partial)
            t = t + b.narrow(-2, h0 - w_lo, h1 - h0).to(x.dtype)
        out[name] = repeat_kv(t, hd.rep).narrow(-2, lo - h0 * hd.rep, n)
    return out


def _used_range(w, dim: int, fsdp) -> tuple:
    """(start, length) along ``dim`` of the slice of ``w`` this rank uses
    once the storage axes ``fsdp`` are gathered (``local_range`` of the
    gathered layout; the whole axis of a plain tensor)."""
    if not is_dtensor(w):
        return 0, w.shape[dim]
    return local_extent(w.shape, Sharding(w.device_mesh, use_placements(
        w, fsdp)))[dim]


def check_prefix_mask(kv_mask):
    """Raise unless every row of ``kv_mask`` (B, I) is a prefix of valid
    positions (right-padded): the decode kernel models validity as a
    per-row length.  One host sync; callers run it where a mask enters a
    decode state, not in every layer at every step.  A DTensor mask is
    read whole, so that every rank of a mesh decides alike."""
    kv_mask = whole(kv_mask)
    I = kv_mask.shape[-1]
    lens = kv_mask.sum(-1)
    pref = torch.arange(I, device=kv_mask.device)[None, :] < lens[:, None]
    if not bool(torch.equal(kv_mask.bool(), pref)):
        raise ValueError("use_kernel cross-attention needs a prefix "
                         "(right-padded) kv_mask; got a non-contiguous "
                         "validity set — use the plain path instead")


def cross_attention_block(cfg: ModelConfig, p: dict, hd: HeadDims, x, *,
                          kv_embeds=None, kv_cache=None, kv_mask=None,
                          use_kernel: bool = False,
                          check_prefix: bool = True, part=NULL):
    """Gated cross-attention (llama-3.2-vision): queries from ``x``
    (B, S, D), K/V either projected here from ``kv_embeds`` (B, I, D) and
    returned as a static cache, or read from ``kv_cache`` {"k","v"}
    (B, I, KvE, dh, any strides with a unit one on dh).  ``kv_mask``
    (B, I) bool marks each row's valid image positions (None: all).  The
    output is ``tanh(gate)`` times the wo projection.

    ``use_kernel`` sends S == 1 decode to the resident decode kernel over
    every q head with per-row lengths ``kv_mask.sum(-1)`` — the engine's
    image buffers are right-padded, so validity is a length prefix, the
    kernel's model of it.  ``check_prefix`` refuses a mask that is not a
    prefix (``ValueError``; a host sync): the model checks masks where
    they enter a decode state and passes False.  A fully masked row (an
    imageless request) comes back from the kernel as zeros and is
    replaced by the plain path's value, the mean of V over the image
    positions.  S > 1, or no kernel: the plain masked attention, as in
    the reference, which has no kernel there.  The CUDA kernel takes any
    image extent (the reference's kernel only one that tiles its block).

    part: with DTensor parameters (a VLM on a mesh) q comes through
    DTensor and attention runs on the rank's shard, as in
    ``self_attention_block``: its batch rows and query heads, the image
    K/V shard it holds (a placed ``kv_cache`` laid out as
    ``IMG_KV_AXES``: its heads' expanded KV rows, checked, never
    redistributed; ``kv_embeds`` raises on a mesh) and its rows of ``kv_mask``; the kernel
    runs over identity rows of the local width, the mean of V is taken
    over the shard's heads (a mean over image positions, per head), and
    ``wo``'s head-sharded contraction is reduced over "model".
    Returns (out, kv_cache)."""
    q = torch.einsum("bsd,dhk->bshk", x, wt(p, "wq", x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = part.constrain(q, ("batch", "seq", "heads", None))
    if kv_cache is None:
        if part.mesh is not None:
            raise NotImplementedError(
                "cross-attention on a mesh reads a placed image K/V "
                "(kv_cache); project it shard by shard with project_kv")
        kv_cache = project_kv(cfg, p, hd, kv_embeds)
    layout, k, v = q, kv_cache["k"], kv_cache["v"]
    if is_dtensor(q):
        q = local(q)
        kv = local_shards(kv_cache, part, {"k": IMG_KV_AXES,
                                           "v": IMG_KV_AXES})
        k, v = kv["k"], kv["v"]
        if kv_mask is not None:
            kv_mask = _rows_of(part, kv_mask, ("batch", "img_seq"))
    B, S = q.shape[0], q.shape[1]
    if use_kernel and S == 1:
        I = k.shape[1]
        if kv_mask is None:
            lens = torch.full((B,), I, dtype=torch.int32, device=q.device)
        else:
            lens = kv_mask.sum(-1).to(torch.int32)
            if check_prefix:
                check_prefix_mask(kv_mask)
        rows = torch.arange(q.shape[2], dtype=torch.int32, device=q.device)
        out = ops.decode_attention_resident_bshd(q, k, v, lens, rows)
        if kv_mask is not None:
            G = q.shape[2] // v.shape[2]
            vm = v.mean(dim=1).repeat_interleave(G, dim=1)[:, None]
            out = torch.where((lens == 0)[:, None, None, None],
                              vm.to(out.dtype), out)
    else:
        mask = None if kv_mask is None else kv_mask[:, None, None, None, :]
        out = attention_scores(q, k, v, mask)
    return _project_out(p, like(out, layout), gate=p["gate"],
                        part=part), kv_cache


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------


def mlp_block(cfg: ModelConfig, p: dict, x, *, part=NULL):
    """SwiGLU, or (``mlp_type="gelu"``) ``gelu(x w_up + b_up) w_down +
    b_down`` with the tanh approximation: ``jax.nn.gelu``'s default, which
    the reference calls (torch's default is the exact erf form)."""
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ wt(p, "w_gate", x.dtype)) * (x @ wt(p, "w_up", x.dtype))
        h = part.constrain(h, ("batch", "seq", "d_ff"))
        out = h @ wt(p, "w_down", x.dtype)
    else:
        h = F.gelu(x @ wt(p, "w_up", x.dtype) + p["b_up"].to(x.dtype),
                   approximate="tanh")
        h = part.constrain(h, ("batch", "seq", "d_ff"))
        # under a mesh ``h @ w_down`` is a partial sum over "model" (h and
        # w_down split d_ff): the bias joins once, after the reduction
        out = part.constrain(h @ wt(p, "w_down", x.dtype),
                             ("batch", "res_seq", "d_model"))
        return out + p["b_down"].to(x.dtype)
    return part.constrain(out, ("batch", "res_seq", "d_model"))


def embed(cfg: ModelConfig, p: dict, tokens, *, part=NULL):
    """Token rows of ``tok_embed``; an int8 table gathers its int8 rows and
    dequantizes only those, into ``cfg.dtype`` (as the reference)."""
    tab = p["tok_embed"]
    if is_quantized(tab) and is_dtensor(tab["q8"]):
        x = _embed_int8_shards(cfg, tab, tokens)
    elif is_quantized(tab):
        rows = tab["q8"][tokens.long()].float()
        x = (rows * tab["sc"]).to(getattr(torch, cfg.dtype))
    else:
        x = F.embedding(tokens.long(), tab)
    return part.constrain(x, ("batch", "res_seq", "d_model"))


def _vocab_rows(cfg: ModelConfig, tab, tokens, lo: int, n: int):
    """The embedding rows of ``tokens`` from a table's vocabulary rows
    ``[lo, lo + n)`` (``tab``: those rows as a plain tensor, or an int8
    leaf of them, dequantized row by row into ``cfg.dtype`` as ``embed``
    does), zeros for the tokens outside them: one rank's term of a sum
    over the ranks that split the vocabulary."""
    t = tokens.long() - lo
    hit = ((t >= 0) & (t < n))[..., None]
    t = t.clamp(0, max(n - 1, 0))
    if is_quantized(tab):
        x = (tab["q8"][t].float() * tab["sc"]).to(getattr(torch, cfg.dtype))
    else:
        x = F.embedding(t, tab)
    return torch.where(hit, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))


def _embed_int8_shards(cfg: ModelConfig, tab: dict, tokens):
    """``embed`` of an int8 table placed on a mesh (``q8``'s vocabulary
    rows over "model", ``placement_bridge.param_spec``): each rank gathers
    the int8 rows of the tokens its vocabulary chunk holds, dequantizes
    only those and zeros the rest (``_vocab_rows``).  The result is a
    partial sum over the mesh dimensions that split the vocabulary (exact:
    one term of each sum is nonzero) and keeps the tokens' batch rows;
    ``embed``'s constraint reduces it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    q8 = tab["q8"]
    mesh = q8.device_mesh
    lo, n = local_range(q8, 0)
    x = _vocab_rows(cfg, {"q8": q8.to_local(), "sc": whole(tab["sc"])},
                    local(tokens), lo, n)
    out = tuple(Partial() if isinstance(pl, Shard) else
                (tokens.placements[m] if is_dtensor(tokens) else Replicate())
                for m, pl in enumerate(q8.placements))
    return from_local(x, Sharding(mesh, out),
                      tuple(tokens.shape) + (x.shape[-1],))


def unembed(cfg: ModelConfig, p: dict, x, *, part=NULL):
    """Logits in float32, through ``lm_head`` (D, V) or, with tied
    embeddings, the transposed ``tok_embed`` (V, D) — either one
    dequantized when int8.  Under sequence parallelism the residual
    stream's sequence is gathered over "model" first (an all-gather whose
    backward is a reduce-scatter: the sequence-parallel region's exit),
    so the product sees the layout it takes without it."""
    x = part.constrain(x, ("batch", "seq", "d_model"))
    w = wt(p, "tok_embed", x.dtype).T if cfg.tie_embeddings \
        else wt(p, "lm_head", x.dtype)
    logits = torch.einsum("bsd,dv->bsv", x, w).float()
    return part.constrain(logits, ("batch", "seq", "vocab"))


def embed_rows(cfg: ModelConfig, p: dict, tokens, shard):
    """``embed`` on local tensors (the recurrent families on a mesh,
    ``partitioning.HeadShard``): ``tok_embed``'s vocabulary rows are
    placed over "model", so each rank looks up the tokens its rows hold,
    zeros for the others, and the rows are summed over "model" (exact:
    one term of each sum is nonzero).  An int8 table's rows are
    dequantized as ``embed`` dequantizes them, by its ``sc`` (placed
    ``(d_model,)``: whole on every rank).  Without a "model" group:
    ``embed``, on the local (whole) table.  Under autograd every rank uses
    the sum alike, so its backward is the identity: each rank's rows take
    their tokens' gradient."""
    if shard.model is None:
        return embed(cfg, p, tokens)
    lo, n = shard.span(cfg.vocab_size)
    return shard.reduce(_vocab_rows(cfg, p["tok_embed"], tokens, lo, n))


def unembed_whole(cfg: ModelConfig, p: dict, x, shard):
    """``unembed`` on local tensors: this rank's vocabulary columns of
    ``lm_head`` (or of the transposed ``tok_embed``) over its batch rows,
    gathered over "model" and the data axes — the whole float32 logits on
    every rank (``partitioning.HeadShard``).  Under autograd ``x`` enters
    the column-split product through ``shard.enter`` and every rank uses
    the gathered logits alike (a loss on every rank): each takes its own
    rows' and columns' gradient back."""
    return shard.whole_rows(shard.gather(unembed(cfg, p, shard.enter(x)),
                                         cfg.vocab_size, redundant=True))


def _token_losses(logits, labels):
    """logsumexp minus the gold logit of each token, float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(-1, labels.long()[..., None])[..., 0]


def cross_entropy(logits, labels):
    """Mean token cross-entropy in float32: logits (B, S, V), labels
    (B, S) int; logsumexp minus the gold logit, averaged.

    Logits that are a DTensor (a sharded forward's, their vocabulary over
    "model") give the same mean over the call's every token, each counted
    once, as a plain tensor the same on every rank: the vocabulary is
    gathered (DTensor's ``redistribute``), each rank sums its own tokens'
    losses (``labels`` — whole, or a DTensor placed as the batch — cut to
    them) and the sums are all-reduced over the mesh dimensions that split
    the tokens, whose backward is the identity: every rank uses the loss
    alike."""
    if not is_dtensor(logits):
        return _token_losses(logits, labels).mean()
    from torch.distributed.tensor import Replicate, Shard
    mesh, vocab = logits.device_mesh, logits.ndim - 1
    logits = logits.redistribute(mesh, tuple(
        Replicate() if isinstance(pl, Shard) and pl.dim == vocab else pl
        for pl in logits.placements))
    ext = local_extent(logits.shape, Sharding(mesh, logits.placements))
    labels = whole(labels)
    for d, (start, n) in enumerate(ext[:-1]):
        labels = labels.narrow(d, start, n)
    total = _token_losses(logits.to_local(), labels.to(
        logits.device_mesh.device_type)).sum()
    names = tuple(mesh.mesh_dim_names)
    total = sum_over(total, [mesh_group(mesh, names[m])
                             for m, pl in enumerate(logits.placements)
                             if isinstance(pl, Shard)])
    return total / math.prod(logits.shape[:-1])
