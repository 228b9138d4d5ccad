"""Decoder-only transformer LM, dense, MoE, audio and VLM families —
counterpart of the JAX package's ``models/transformer.py``.  The audio
family (musicgen-large) is the reference's decoder over one stream of
codec tokens: LayerNorm, a GELU MLP with biases and RoPE, its frontend
stubbed.  The VLM (llama-3.2-vision) stacks its layers as supergroups of
[3 self, 1 gated cross-attention, 1 self]: self layers ``(G, 4, ...)``,
cross layers ``(G, ...)``; the cross layers' K/V are projected once from
the (stubbed) image embeddings and live in the decode state.

Parameters are a nested dict in the reference's names and stacked
``(L, ...)`` layouts, so a head or expert migration is the same row
permutation in both packages.  The reference's ``lax.scan`` over layers
becomes a Python loop over per-layer views of the stacked params and
cache, and the KV cache — linear, paged or (sliding-window archs) a ring
of ``window`` slots, in the working dtype or int8 with per-(token, head)
scales — is updated in place (the reference donates its state instead).

Training differentiates the plain path (``use_kernel=False``), as the
reference's does: no kernel has a backward.  ``remat`` maps the
reference's ``REMAT_POLICIES`` onto ``torch.utils.checkpoint`` around each
layer (:func:`remat_call`).  The reference also pins each layer's param
slice with ``layers.pin_layer_slice``, a barrier against XLA hoisting a
sharded all-gather out of its layer scan; a Python loop over layer views
has nothing to hoist, so it has no counterpart here.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_block, moe_block_capacity
from repro_torch.models.partitioning import (NULL, Sharding, dp_degree,
                                             from_local, fsdp_axes,
                                             is_dtensor, local,
                                             local_extent, local_range,
                                             place, placed_full, row_owner,
                                             tp_degree, whole)
from repro_torch.tree import flatten, map_with_path

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the reference's remat policies: "full" saves nothing inside a layer, the
# other two save the outputs of its matrix products (without the batched
# ones for "dots_no_batch") and recompute the rest in the backward pass
_MATMUL_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT_POLICIES = {
    "none": None,
    "full": (),
    "dots": _MATMUL_OPS + (torch.ops.aten.bmm.default,),
    "dots_no_batch": _MATMUL_OPS,
}

# decay of the router-load EWMA kept in the decode state ("expert_load"):
# load_t = d*load_{t-1} + (1-d)*freq_t.  The serving engine normalizes and
# feeds it to the controller's expert cost model each interval.
EXPERT_LOAD_EWMA = 0.9
# d and 1 - d as the reference computes them, in float32
_EWMA_D = float(np.float32(EXPERT_LOAD_EWMA))
_EWMA_1MD = float(np.float32(1.0) - np.float32(EXPERT_LOAD_EWMA))


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def check_remat(remat: str) -> str:
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; expected one of "
                         f"{sorted(REMAT_POLICIES)}")
    return remat


def _save_policy(saved_ops):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved_ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def remat_call(remat: str, fn, *args, part=NULL):
    """``fn(*args)``, under activation checkpointing when ``remat`` names
    a policy and autograd records: ``"full"`` keeps only the layer's
    inputs, ``"dots"`` and ``"dots_no_batch"`` also the matmul outputs
    (selective checkpointing).  The recomputation runs the same ops on the
    same inputs, so gradients keep their bits.

    On a mesh (``part``) the layer's collectives — the fsdp gathers, the
    explicit ones of the layers on local tensors, DTensor's — run again in
    the recomputation.  It is non-reentrant: autograd runs it when the
    backward first needs a saved tensor of the layer, at the same point of
    the same graph on every rank, so every rank issues them in the same
    order.  It runs in ``part.region()``, as the forward did (the
    backward runs outside the forward's ``with``)."""
    saved = REMAT_POLICIES[remat]
    if saved is None or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if saved:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            _save_policy(frozenset(saved)))

    def run(*a):
        with part.region():
            return fn(*a)
    return checkpoint(run, *args, use_reentrant=False, **kw)


def _layer_view(tree, l):
    """Layer ``l`` (an index, or a tuple of them for the VLM's (G, 4)
    stacks) of every tensor of a stacked params or cache tree."""
    if isinstance(tree, dict):
        return {k: _layer_view(v, l) for k, v in tree.items()}
    return tree[l]


def state_shardings(tree, cfg: ModelConfig, part,
                    batch: Optional[int] = None) -> dict:
    """{leaf path: ``Sharding``} of a fresh cache or decode state on
    ``part``'s mesh: ``placement_bridge.decode_state_shardings`` (the
    reference's rules: a KV cache's batch rows over "data" and its
    expanded KV heads over "model", int8 scales alike, WKV and SSM states
    their heads over "model", conv tails their channels, token shifts
    batch rows only, positions replicated), with the cache's sequence —
    a ring's slots — over "data" and no batch axis where ``part`` takes
    the long-decode rules (``make_partitioner(seq_over_data=True)``).  A
    ``batch`` that does not split over the data axes (a one-row admission
    prefill) stays whole there (``Partitioner.for_batch``); a sequence
    shard is no batch axis and stays.  Under the zero3 layout (its "batch"
    rule names "model" too) the batch lies over every mesh dimension and
    the heads over none, as that layout's intermediates do."""
    from torch.distributed.tensor import Replicate
    from repro_torch.core.placement_bridge import decode_state_shardings
    mesh = part.mesh
    names = tuple(mesh.mesh_dim_names)
    seq_over_data = part.rules.get("cache_seq") is not None
    over = part.rules.get("batch") or ()
    over = over if isinstance(over, tuple) else (over,)
    keep = batch is not None and not seq_over_data \
        and part.for_batch(batch) is not part
    shardings = flatten(decode_state_shardings(
        tree, cfg, mesh, seq_over_data=seq_over_data,
        layout="zero3" if "model" in over else "tp"))
    if keep:
        shardings = {path: Sharding(mesh, tuple(
            Replicate() if n in over else pl
            for n, pl in zip(names, sh.placements)))
            for path, sh in shardings.items()}
    return shardings


def place_state(tree, cfg: ModelConfig, part, batch: Optional[int] = None):
    """``tree`` — a fresh cache or decode state — on ``part``'s mesh,
    placed as ``state_shardings`` says.  Buffers made on the meta device
    are built shard by shard (``partitioning.placed_full``), so no rank
    ever allocates the whole cache or state; small leaves are cut from
    the whole (``place``).  Without a mesh: ``tree`` itself."""
    if part.mesh is None:
        return tree
    shardings = state_shardings(tree, cfg, part, batch)

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor) or is_dtensor(leaf):
            return leaf
        if leaf.device.type == "meta":
            return placed_full(leaf.shape, 0, leaf.dtype, shardings[path])
        return place(leaf, shardings[path])
    return map_with_path(one, tree)


# the VLM's supergroup: self layers 0-2, the cross layer, self layer 3
SELF_BEFORE_CROSS = 3


class TransformerLM:
    """Config-driven dense, MoE, audio or VLM decoder-only LM.

    ``tp`` lays the heads out for head-level tensor parallelism at that
    degree (``layers.head_dims``: query heads zero-padded to ``Hp``, KV
    heads repeated ``rep`` times into ``KvE`` cache rows); on one device
    it computes the tp-1 function.  ``part`` (``partitioning``) maps the
    intermediates onto a ``DeviceMesh``: with the parameters placed as
    DTensors (``placement_bridge.param_shardings``; a MoE model's expert
    stacks over "pod"), ``forward``, the prefills and ``decode_step`` run
    sharded over the mesh — the MoE layers on local tensors with explicit
    collectives (``moe.moe_block``), a VLM's cross layers over the rank's
    image K/V shard — and every fresh cache and decode state, a ring and
    a VLM's image K/V too, is placed as
    ``placement_bridge.decode_state_shardings`` says, each rank building
    only its own shard (``place_state``)."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device,
                 use_kernel: bool = False, capacity_moe: bool = False,
                 capacity_factor: float = 1.25, remat: str = "none",
                 tp: int = 1, part=NULL):
        if cfg.family not in ("dense", "moe", "audio", "vlm"):
            raise ValueError(f"TransformerLM serves the dense, moe, audio "
                             f"and vlm families, not {cfg.family!r}")
        self.cfg = cfg
        self.part = part
        self.hd = L.head_dims(cfg, tp)
        self.device = torch.device(device)
        # decode attention through the hand-written flash-decode kernels
        # and aligned prefill attention through the flash attention kernel;
        # the decode state may carry per-layer "head_rows"/"head_inv"
        # gather maps (placement_bridge.head_row_maps)
        self.use_kernel = use_kernel
        # MoE layers through GShard capacity dispatch
        # (``moe.moe_block_capacity``) instead of dense dispatch
        self.capacity_moe = capacity_moe
        self.capacity_factor = capacity_factor
        # activation checkpointing of each layer under autograd
        self.remat = check_remat(remat)
        self.is_vlm = cfg.family == "vlm"
        if self.is_vlm:
            if cfg.n_layers % 5:
                raise ValueError(f"a VLM stacks supergroups of 5 layers; "
                                 f"got {cfg.n_layers}")
            self.n_groups = cfg.n_layers // 5
        self.window = cfg.sliding_window
        if part.mesh is not None:
            m = tp_degree(part.mesh)
            if self.hd.Hp % m or self.hd.KvE % m:
                raise ValueError(
                    f"the mesh's model degree {m} must divide the padded "
                    f"query heads ({self.hd.Hp}) and the cache's KV rows "
                    f"({self.hd.KvE}): build with tp a multiple of it")
            names = tuple(part.mesh.mesh_dim_names)
            pod = part.mesh.size(names.index("pod")) if "pod" in names \
                else 1
            if cfg.is_moe and cfg.n_experts % pod:
                raise ValueError(
                    f"the mesh's \"pod\" degree {pod} must divide the "
                    f"{cfg.n_experts} experts: each pod rank holds an equal "
                    f"share of the expert rows")

    # ------------------------------------------------------------------ init
    def _init_layers(self, g: torch.Generator, lead: tuple, *,
                     cross: bool = False) -> dict:
        """One layer's weights stacked over ``lead``: attention (a cross
        layer's with its ``gate``), the norms (LayerNorm configs with zero
        biases), then the MLP or MoE block; a cross layer adds the MLP
        gate ``gate_ffn``, zero as the reference initializes it."""
        cfg = self.cfg
        dt, dev = torch_dtype(cfg.param_dtype), self.device
        layers = {"attn": L.init_attention(g, cfg, self.hd, lead, dt, dev,
                                           cross=cross)}
        for name in ("ln1", "ln2"):
            layers[name] = torch.ones(lead + (cfg.d_model,), dtype=dt,
                                      device=dev)
            if cfg.norm_type == "layernorm":
                layers[name + "_b"] = torch.zeros(lead + (cfg.d_model,),
                                                  dtype=dt, device=dev)
        if cfg.is_moe:
            layers["moe"] = init_moe(g, cfg, lead[0], dt, dev)
        else:
            layers["mlp"] = L.init_mlp(g, cfg, lead, dt, dev)
        if cross:
            layers["gate_ffn"] = torch.zeros(lead, dtype=dt, device=dev)
        return layers

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights at the reference's init scales (normal draws
        from ``generator``, which must live on this model's device), in
        its tree: LayerNorm configs add zero biases ``ln1_b``, ``ln2_b``
        and ``ln_f_b``, GELU MLPs zero ``b_up`` and ``b_down``, and tied
        embeddings have no ``lm_head``.  A VLM's self layers stack as
        ``(G, 4, ...)`` and its gated cross layers as ``(G, ...)``
        (``cross_layers``; both gates zero, as the reference's)."""
        cfg = self.cfg
        D, V = cfg.d_model, cfg.vocab_size
        dt, dev, g = torch_dtype(cfg.param_dtype), self.device, generator
        layer_norm = cfg.norm_type == "layernorm"
        if self.is_vlm:
            params = {"layers": self._init_layers(g, (self.n_groups, 4)),
                      "cross_layers": self._init_layers(
                          g, (self.n_groups,), cross=True)}
        else:
            params = {"layers": self._init_layers(g, (cfg.n_layers,))}
        params["tok_embed"] = L.normal_init(g, (V, D), 0.02, dt, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(g, D, (D, V), dt, dev)
        params["ln_f"] = torch.ones((D,), dtype=dt, device=dev)
        if layer_norm:
            params["ln_f_b"] = torch.zeros((D,), dtype=dt, device=dev)
        return params

    # ----------------------------------------------------------------- layer
    def _layer(self, p: dict, x, positions, cache, cache_pos,
               head_rows=None, head_inv=None, page_map=None,
               write_valid=None, part=None):
        """One decoder layer (``part``: the call's partitioner, the model's
        by default).  Returns the new hidden state and, for MoE layers, the
        float32 aux loss and the (E,) routed-token fraction of this call
        (else None, None)."""
        cfg, part = self.cfg, part or self.part
        p = part.gather_params(p)
        h = L.apply_norm(cfg, p, "ln1", x)
        # the boundary into the tensor-parallel region, on the working-dtype
        # tensor (the reference's explicit constraint)
        h = part.constrain(h, ("batch", "seq", "d_model"))
        attn_out, _ = L.self_attention_block(
            cfg, p["attn"], self.hd, h, positions, cache=cache,
            cache_pos=cache_pos, window=self.window,
            use_kernel=self.use_kernel, head_rows=head_rows,
            head_inv=head_inv, page_map=page_map, write_valid=write_valid,
            part=part)
        x = x + attn_out
        h = L.apply_norm(cfg, p, "ln2", x)
        h = part.constrain(h, ("batch", "seq", "d_model"))
        if cfg.is_moe:
            if self.capacity_moe:
                out, aux, freq = moe_block_capacity(
                    cfg, p["moe"], h, self.capacity_factor, part=part)
            else:
                out, aux, freq = moe_block(cfg, p["moe"], h, part=part)
            return x + out, aux, freq
        return x + L.mlp_block(cfg, p["mlp"], h, part=part), None, None

    def _cross_layer(self, p: dict, x, img_kv, img_mask, part=None):
        """A gated cross-attention layer over the image K/V ``img_kv``
        {"k","v"} (B, I, KvE, dh): attention gated by ``tanh(gate)``, the
        MLP by ``tanh(gate_ffn)``.  Masks reach it checked
        (``_check_img_mask``).  ``part``: the call's partitioner, the
        model's by default."""
        cfg, part = self.cfg, part or self.part
        p = part.gather_params(p)
        # the tensor-parallel region's entries, as in ``_layer``
        h = part.constrain(L.apply_norm(cfg, p, "ln1", x),
                           ("batch", "seq", "d_model"))
        attn_out, _ = L.cross_attention_block(
            cfg, p["attn"], self.hd, h, kv_cache=img_kv, kv_mask=img_mask,
            use_kernel=self.use_kernel, check_prefix=False, part=part)
        x = x + attn_out
        h = part.constrain(L.apply_norm(cfg, p, "ln2", x),
                           ("batch", "seq", "d_model"))
        return x + L.mlp_block(cfg, p["mlp"], h, part=part) \
            * torch.tanh(p["gate_ffn"]).to(x.dtype)

    def _project_img_kv(self, params, img_embeds) -> dict:
        """The cross layers' image K/V {"k","v"} (G, B, I, KvE, dh) of
        ``img_embeds`` (B, I, D), in the embeddings' dtype, each KV head
        repeated ``rep`` times.  On a mesh the K/V are placed as the cross
        layers read them (``layers.IMG_KV_AXES``; under the tp rules that
        is ``decode_state_shardings``' layout: batch rows over the data
        axes, KvE over "model"; a batch that does not split stays whole
        there) and built shard by shard: each rank projects its batch rows onto
        its heads' KV rows (``layers.project_kv`` of a shard; weights
        stored over "data" gathered on use), so no rank holds the whole
        image K/V; the shards, stacked, become the DTensor (under
        autograd too: the cross layers' gradients reach the
        projection)."""
        cross = params["cross_layers"]
        if self.part.mesh is None:
            kv = [L.project_kv(self.cfg, _layer_view(cross, g)["attn"],
                               self.hd, img_embeds)
                  for g in range(self.n_groups)]
            return {n: torch.stack([t[n] for t in kv]) for n in ("k", "v")}
        B, I = img_embeds.shape[0], img_embeds.shape[1]
        shape = (self.n_groups, B, I, self.hd.KvE, self.hd.dh)
        # the cross layers' layout of it (under the tp rules the
        # decode-state rule's too; under zero3 its batch over every axis)
        sh = self.part.for_batch(B).sharding((None,) + L.IMG_KV_AXES)
        ext = local_extent(shape, sh)
        names = tuple(sh.mesh.mesh_dim_names)
        # the mesh dimensions splitting the projection: the weights'
        # gradients are partial sums over them
        split = tuple(names[m] for m, pl in enumerate(sh.placements)
                      if not pl.is_replicate())
        shards = [L.project_kv(self.cfg, _layer_view(cross, g)["attn"],
                               self.hd, img_embeds, rows=ext[1],
                               heads=ext[3], fsdp=fsdp_axes(self.part),
                               partial=split)
                  for g in range(self.n_groups)]
        return {n: from_local(torch.stack([t[n] for t in shards]), sh,
                              shape) for n in ("k", "v")}

    def _check_img_mask(self, img_mask):
        """A mask the decode kernel reads as per-row lengths must be a
        prefix of each row; checked once where it enters a state or a
        forward (a host sync), never per layer and step."""
        if self.use_kernel and img_mask is not None:
            L.check_prefix_mask(img_mask)

    def _run_layers_vlm(self, params, x, positions, cache, cache_pos,
                        img_kv, img_mask, part=None):
        """The VLM's supergroups [3 self, 1 cross, 1 self]: self layer
        (g, i) reads ``params["layers"]`` and the cache at (g, i), cross
        layer g ``params["cross_layers"]`` and the image K/V at g.  Self
        attention decodes over identity head rows (the reference threads
        no row maps into a VLM's grouped stacks; on a mesh, identity rows
        of the rank's local width).  ``remat`` checkpoints each layer;
        ``part`` is the call's partitioner.  The VLM has no MoE: its aux
        loss is zero."""
        for g in range(self.n_groups):
            for i in range(4):
                if i == SELF_BEFORE_CROSS:
                    x = remat_call(self.remat, self._cross_layer,
                                   _layer_view(params["cross_layers"], g), x,
                                   _layer_view(img_kv, g), img_mask, part,
                                   part=part or self.part)
                layer_cache = None if cache is None else \
                    {name: buf[g, i] for name, buf in cache.items()}
                x, _, _ = remat_call(
                    self.remat, self._layer,
                    _layer_view(params["layers"], (g, i)), x, positions,
                    layer_cache, cache_pos, None, None, None, None, part,
                    part=part or self.part)
        return x, None, torch.zeros((), dtype=torch.float32,
                                    device=x.device)

    def _run_layers(self, params, x, positions, cache, cache_pos,
                    head_rows=None, head_inv=None, page_map=None,
                    write_valid=None, img_kv=None, img_mask=None,
                    part=None):
        """Loop over layers; layer l reads its slice of the stacked params,
        cache (values, int8 scales, ring positions) and (n_layers, Hp)
        kernel row maps.  One page map (and ``write_valid``) serves every
        layer: the layer axis lives in the page store, not the table.  A
        VLM runs its supergroups over ``img_kv`` and ``img_mask``
        instead.  Returns the hidden state, for MoE the stacked (L, E)
        router loads of this call (else None), and the float32 aux loss
        summed over layers in order, as the reference's layer scan sums
        it (zero without MoE).  ``remat`` checkpoints each layer; ``part``
        is the call's partitioner (``Partitioner.for_batch``)."""
        if self.is_vlm:
            return self._run_layers_vlm(params, x, positions, cache,
                                        cache_pos, img_kv, img_mask, part)
        freqs = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for l in range(self.cfg.n_layers):
            layer_cache = None if cache is None else \
                {name: buf[l] for name, buf in cache.items()}
            x, a, freq = remat_call(
                self.remat, self._layer,
                _layer_view(params["layers"], l), x, positions, layer_cache,
                cache_pos, None if head_rows is None else head_rows[l],
                None if head_inv is None else head_inv[l], page_map,
                write_valid, part, part=part or self.part)
            if a is not None:
                aux = aux + a
            freqs.append(freq)
        return x, (torch.stack(freqs) if self.cfg.is_moe else None), aux

    def _with_top(self, params):
        """``params`` with its top-level leaves (embeddings, head, final
        norm) gathered over the storage axes for this call
        (``Partitioner.gather_params``); the layer stacks are gathered
        layer by layer, in ``_layer``."""
        if self.part.mesh is None:
            return params
        return {k: v if k in ("layers", "cross_layers")
                else self.part.gather_params(v) for k, v in params.items()}

    def _positions(self, B: int, S: int):
        return torch.arange(S, dtype=torch.int32,
                            device=self.device)[None].expand(B, S)

    def forward(self, params, tokens, *, img_embeds=None, img_mask=None):
        """Full-sequence forward without a cache.  Returns (logits (B, S, V)
        float32, aux): the MoE load-balancing loss summed over layers
        (float32, zero without MoE).  A VLM takes its image embeddings
        (B, I, D) and mask (B, I).

        With a mesh (``part``) and DTensor parameters this is the sharded
        forward: tokens (placed, or placed here) and positions shard their
        batch rows over the data axes, the einsums run through DTensor's
        propagation, each ``constrain`` redistributes (the residual
        layout reduces a head- or d_ff-sharded contraction), and the
        logits come back as a DTensor sharded over the vocabulary.  A
        batch that does not split over the data axes (one row) stays
        whole there (``Partitioner.for_batch``)."""
        B, S = tokens.shape
        part = self.part.for_batch(B)
        params = self._with_top(params)
        with part.region():
            tokens = part.shard(tokens, ("batch", "seq"))
            positions = part.shard(self._positions(B, S), ("batch", "seq"))
            x = L.embed(self.cfg, params, tokens, part=part)
            img_kv = None
            if self.is_vlm:
                self._check_img_mask(img_mask)
                img_kv = self._project_img_kv(params, img_embeds)
            x, _, aux = self._run_layers(params, x, positions, None, None,
                                         img_kv=img_kv, img_mask=img_mask,
                                         part=part)
            x = L.apply_norm(self.cfg, params, "ln_f", x)
            return L.unembed(self.cfg, params, x, part=part), aux

    def loss(self, params, batch):
        """Mean token cross-entropy of ``batch["labels"]`` plus 0.01 times
        the aux loss; a VLM's images come in ``img_embeds``/``img_mask``."""
        logits, aux = self.forward(params, batch["tokens"],
                                   img_embeds=batch.get("img_embeds"),
                                   img_mask=batch.get("img_mask"))
        return L.cross_entropy(logits, batch["labels"]) + 0.01 * aux

    # ----------------------------------------------------------------- cache
    def _kv_buffers(self, lead: tuple, dtype=None, *,
                    quant: Optional[bool] = None) -> dict:
        """Zeroed K/V buffers of shape ``lead + (KvE, dh)``: int8 values
        plus float32 per-(token, head) scales ``lead + (KvE,)`` for
        ``kv_quant`` configs (half the resident cache; dequantized at the
        attention read; ``quant`` overrides the config), else the working
        dtype.  On a mesh they are made on the meta device, with no
        memory, for ``_placed`` to build each rank's shard."""
        z = functools.partial(torch.zeros, device="meta" if self.part.mesh
                              is not None else self.device)
        shape = lead + (self.hd.KvE, self.hd.dh)
        if self.cfg.kv_quant if quant is None else quant:
            return {"k": z(shape, dtype=torch.int8),
                    "v": z(shape, dtype=torch.int8),
                    "k_sc": z(shape[:-1], dtype=torch.float32),
                    "v_sc": z(shape[:-1], dtype=torch.float32)}
        dtype = dtype or torch_dtype(self.cfg.dtype)
        return {"k": z(shape, dtype=dtype), "v": z(shape, dtype=dtype)}

    def _placed(self, tree, batch: Optional[int] = None):
        """``tree`` — a fresh cache or decode state — on the model's mesh
        (``place_state``); without a mesh, ``tree`` itself."""
        return place_state(tree, self.cfg, self.part, batch)

    def cache_len(self, max_seq: int) -> int:
        return min(max_seq, self.window) if self.window else max_seq

    def init_cache(self, batch: int, max_seq: int, dtype=None) -> dict:
        """Stacked (L, batch, T, KvE, dh) K/V with T = ``cache_len`` (a
        VLM's self layers: (G, 4, batch, T, KvE, dh)).  A sliding-window
        arch served to at least its window keeps a ring of ``window``
        slots in the working dtype (int8 does not apply to a ring, as in
        the reference) with "pos" (L, window) holding each slot's absolute
        position, ``EMPTY_SLOT`` until written.  On a mesh each rank builds
        its shard (``_placed``); "pos" is replicated."""
        T = self.cache_len(max_seq)
        if self.is_vlm:
            return self._placed(
                self._kv_buffers((self.n_groups, 4, batch, T), dtype), batch)
        lead = (self.cfg.n_layers, batch, T)
        if self.window and T == self.window:
            ring = self._kv_buffers(lead, dtype, quant=False)
            ring["pos"] = torch.full((self.cfg.n_layers, T), L.EMPTY_SLOT,
                                     dtype=torch.int32, device=self.device)
            return self._placed(ring, batch)
        return self._placed(self._kv_buffers(lead, dtype), batch)

    def init_decode_state(self, params, batch: int, max_seq: int, *,
                          img_embeds=None, img_mask=None, dtype=None,
                          per_slot: bool = False) -> Dict[str, Any]:
        """``per_slot=True`` keeps one position per batch row (continuous
        batching): decode advances each slot independently and prefills
        land rows at different depths via :meth:`insert_slot`.  Otherwise
        the batch decodes in lock-step from one int position (the wave
        scheduler's state, and the only one a ring cache takes).  MoE
        states carry the router-load EWMA "expert_load" (L, E), a uniform
        prior that ``decode_step`` updates.  A VLM state carries the image
        K/V "img_kv" (G, B, I, KvE, dh), projected here from
        ``img_embeds`` (B, I, D), and its mask "img_mask" (B, I) bool
        (None: every position valid), checked to be a prefix of each row
        when the kernels decode."""
        pos = torch.zeros((batch,), dtype=torch.int32,
                          device=self.device) if per_slot else 0
        state = {"cache": self.init_cache(batch, max_seq, dtype), "pos": pos}
        if self.cfg.is_moe:
            E = self.cfg.n_experts
            state["expert_load"] = torch.full(
                (self.cfg.n_layers, E), 1.0 / E, dtype=torch.float32,
                device=self.device)
        if self.is_vlm:
            if img_embeds is None:
                raise ValueError("a VLM decode state needs img_embeds "
                                 "(B, I, d_model)")
            self._check_img_mask(img_mask)
            state["img_kv"] = self._project_img_kv(params, img_embeds)
            state["img_mask"] = img_mask
        # on a mesh: "img_mask" (B, I) and every other plain leaf placed by
        # the decode-state rules (the cache and image K/V already are)
        return self._placed(state, batch)

    def prefill(self, params, state, tokens):
        """Lock-step prefill: run the (B, S) prompts, all of length S,
        through the model from position 0, filling the cache in place.
        Returns the last token's logits (B, V), whole on every rank of a
        mesh, and the state with ``pos == S``."""
        B, S = tokens.shape
        params = self._with_top(params)
        x, part = self._prefill_layers(params, state, tokens,
                                       self._positions(B, S))
        with part.region():
            logits = whole(L.unembed(self.cfg, params, x[:, -1:], part=part))
        state["pos"] = S
        return logits[:, 0], state

    def _prefill_layers(self, params, state, tokens, positions, *,
                        page_map=None, write_valid=None, owner=()):
        """Embed ``tokens`` (B, S) and run every layer from the cache write
        at position 0 (a paged chunk: through ``page_map`` from its own
        positions); returns the final-norm hidden state and the call's
        partitioner (``Partitioner.for_batch``; ``owner``: the batch rank
        whose pool holds a paged chunk's row, ``Partitioner.owned_by``).
        On a mesh the tokens, positions and page table are cut to each
        rank's batch rows."""
        cfg = self.cfg
        part = self.part.for_batch(tokens.shape[0])
        if owner:
            part = part.owned_by(owner)
        with part.region():
            tokens = part.shard(tokens, ("batch", "seq"))
            positions = part.shard(positions, ("batch", "seq"))
            if page_map is not None:
                page_map = part.shard(page_map, ("batch", None))
                write_valid = part.shard(write_valid, ("batch", "seq"))
            x = L.embed(cfg, params, tokens, part=part)
            x, _, _ = self._run_layers(
                params, x, positions, state["cache"],
                0 if page_map is None else None, page_map=page_map,
                write_valid=write_valid, img_kv=state.get("img_kv"),
                img_mask=state.get("img_mask"), part=part)
            return L.apply_norm(cfg, params, "ln_f", x), part

    # ----------------------------------------------- continuous batching
    def prefill_bucketed(self, params, state, tokens, length):
        """Prefill right-padded prompts: ``tokens`` (B, Lb) padded to a
        bucket length, ``length`` (B,) true prompt lengths.  Returns the
        logits of each row's LAST REAL token (whole on every rank of a
        mesh) and the state with ``pos == length``.  Padding writes
        garbage K/V at indices >= length, which the causal mask hides until
        decode overwrites it."""
        B, S = tokens.shape
        params = self._with_top(params)
        x, part = self._prefill_layers(params, state, tokens,
                                       self._positions(B, S))
        with part.region():
            idx = (length.long() - 1).clamp(min=0)[:, None, None]
            idx = part.shard(idx.expand(B, 1, x.shape[-1]),
                             ("batch", None, None))
            last = x.gather(1, idx)                          # (B, 1, D)
            logits = whole(L.unembed(self.cfg, params, last, part=part))
        state["pos"] = self._placed(
            {"pos": length.to(torch.int32).clone()})["pos"]
        return logits[:, 0], state

    def insert_slot(self, state, sub, slot: int):
        """Copy a batch-1 prefilled ``sub`` state (cache length Lb <= T)
        into batch row ``slot`` of the per-slot decode state, in place.
        int8 caches splice their scales ((L, B, T, KvE)) with the values:
        values without their scales would dequantize garbage.  The batch
        axis sits before the cache's last ``4`` axes of values (``3`` of
        scales), so one rule covers (L, B, T, KvE, dh) and the VLM's
        (G, 4, B, T, KvE, dh); a VLM also splices the request's image K/V
        (G, B, I, KvE, dh) and mask rows.  On a mesh each rank copies its
        heads' shard of the cache and the image K/V, and only the data
        rank holding row ``slot`` writes it."""
        for name, src in sub["cache"].items():
            dst = state["cache"][name]
            tail = 3 if name.endswith("_sc") else 4
            lo, n = local_range(dst, dst.dim() - tail)
            if not lo <= slot < lo + n:
                continue
            dst, src = local(dst), local(src)
            lead = (slice(None),) * (dst.dim() - tail)
            dst[lead + (slot - lo, slice(0, src.shape[-tail + 1]))].copy_(
                src[lead + (0,)])
        local(state["pos"])[slot] = local(sub["pos"])[0]
        if "img_kv" in state and "img_kv" in sub:
            for name, src in sub["img_kv"].items():
                dst = state["img_kv"][name]
                lo, n = local_range(dst, 1)
                if lo <= slot < lo + n:
                    local(dst)[:, slot - lo].copy_(local(src)[:, 0])
        if state.get("img_mask") is not None \
                and sub.get("img_mask") is not None:
            self._check_img_mask(sub["img_mask"])
            lo, n = local_range(state["img_mask"], 0)
            if lo <= slot < lo + n:
                local(state["img_mask"])[slot - lo] = \
                    local(sub["img_mask"])[0]
        return state

    def decode_step(self, params, state, tokens):
        """One autoregressive step for every row. tokens: (B,) int.
        Returns (logits (B, V) float32, whole on every rank of a mesh,
        state).

        A per-slot state's rows each embed, attend and write at their own
        position; positions advance in place and clamp at the cache edge —
        the page table's logical span ``np · P`` for a paged state — where
        a retired slot's writes drop.  A lock-step state's int position
        advances by one (a ring cache wraps, so it has no edge).  MoE
        states fold this step's router loads into "expert_load"."""
        cfg, part = self.cfg, self.part
        params = self._with_top(params)
        pos = state["pos"]
        per_slot = isinstance(pos, torch.Tensor)
        page_map = state.get("page_map")
        B = tokens.shape[0]
        if per_slot:
            pos = local(pos)         # replicated: every row's position
            positions = pos[:, None]
        else:
            positions = torch.full((B, 1), pos, dtype=torch.int32,
                                   device=self.device)
        with part.region():
            cache_pos = part.shard(pos, ("batch",)) if per_slot else pos
            if page_map is not None:
                page_map = part.shard(page_map, ("batch", None))
            x = L.embed(cfg, params, part.shard(tokens[:, None],
                                                ("batch", "seq")), part=part)
            x, freqs, _ = self._run_layers(
                params, x, part.shard(positions, ("batch", "seq")),
                state["cache"], cache_pos, state.get("head_rows"),
                state.get("head_inv"), page_map,
                img_kv=state.get("img_kv"), img_mask=state.get("img_mask"))
            x = L.apply_norm(cfg, params, "ln_f", x)
            logits = whole(L.unembed(cfg, params, x, part=part))
        if not per_slot:
            state["pos"] = pos + 1
        else:
            if page_map is not None:
                T = page_map.shape[1] * state["cache"]["k"].shape[2]
            else:
                T = state["cache"]["k"].shape[-3]
            pos.add_(1).clamp_(max=T)
        if freqs is not None and "expert_load" in state:
            # XLA evaluates the reference's d * load + (1 - d) * freq as one
            # fused multiply-add, fma(d, load, (1 - d) * freq); in float64
            # the product d * load is exact, so one rounding to float32
            # gives the same bits.  On a mesh the load's layer axis is
            # sharded over the data axes (the decode-state rule): each rank
            # writes its layers (the routed fractions are whole everywhere)
            lo, n = local_range(state["expert_load"], 0)
            load = local(state["expert_load"])
            load.copy_(load.double() * _EWMA_D
                       + (freqs[lo:lo + n] * _EWMA_1MD).double())
        return logits[:, 0], state

    # ------------------------------------------------------- paged caching
    def init_paged_cache(self, n_pages: int, page_size: int,
                         dtype=None) -> dict:
        """Pooled page store: stacked (L, n_pages + 1, P, KvE, dh) (int8
        configs page their (L, n_pages + 1, P, KvE) scales alongside).  The
        batch × seq extent of the dense cache becomes a page axis shared by
        every slot.  Page ``n_pages`` is a sink the allocator never hands
        out: writes the reference drops land there
        (``layers._paged_write``).

        On a mesh the store's page axis lies over the batch axes, as the
        decode-state rules place it, and its KV rows over "model": each of
        the ``dp`` batch ranks holds a pool of its own, ``n_pages / dp``
        pages plus its own sink, built shard by shard — local (L,
        n_pages/dp + 1, P, KvE/tp, dh), the whole (L, n_pages + dp, ...).
        A pool that does not split evenly raises."""
        if self.window:
            raise NotImplementedError(
                "paged caches are linear; sliding-window archs keep the "
                "ring cache")
        if self.is_vlm:
            raise NotImplementedError(
                "paged caches do not yet carry the VLM image K/V")
        dp = dp_degree(self.part.mesh) if self.part.mesh is not None else 1
        if n_pages % dp:
            raise ValueError(f"a pool of {n_pages} pages does not split "
                             f"over the mesh's {dp} batch ranks")
        return self._placed(self._kv_buffers(
            (self.cfg.n_layers, n_pages + dp, page_size), dtype))

    def init_paged_state(self, params, batch: int, n_pages: int,
                         page_size: int, pages_per_slot: int,
                         dtype=None) -> Dict[str, Any]:
        """Per-slot paged decode state: the page store, per-row positions,
        and the (batch, pages_per_slot) page table — all -1 (unmapped)
        until the engine mounts an allocation.  On a mesh the table's rows
        lie with their batch rank (each naming pages of that rank's pool)
        and the positions are replicated; ``batch`` must split evenly over
        the batch ranks."""
        if self.part.mesh is not None and batch % dp_degree(self.part.mesh):
            raise ValueError(f"a paged state of {batch} rows does not split "
                             f"over the mesh's "
                             f"{dp_degree(self.part.mesh)} batch ranks")
        return self._placed(
            {"cache": self.init_paged_cache(n_pages, page_size, dtype),
             "pos": torch.zeros((batch,), dtype=torch.int32,
                                device=self.device),
             "page_map": torch.full((batch, pages_per_slot), -1,
                                    dtype=torch.int32, device=self.device)},
            batch)

    def prefill_paged(self, params, state, tokens, row: int, start: int,
                      length: int):
        """One fixed-shape chunk of a paged prefill: ``tokens`` (1, C) holds
        the chunk right-padded to the chunk size, ``row`` the slot row,
        ``start`` the chunk's absolute start position and ``length`` its
        valid token count.  K/V land in the row's mapped pages (the padded
        tail's writes drop); returns the logits of the chunk's last valid
        token (meaningful on the final chunk; whole on every rank of a
        mesh) and the state with ``pos[row] = start + length``, updated in
        place.  On a mesh every rank runs the chunk; only the batch rank
        holding ``row`` maps it to pages (of its pool), and every rank takes
        that rank's attention output (``Partitioner.from_owner``)."""
        C = tokens.shape[1]
        params = self._with_top(params)
        steps = torch.arange(C, dtype=torch.int32, device=self.device)
        # the row's table row as this rank holds it: rank-local page ids
        # where its batch rank holds the row, else unmapped
        pm = state["page_map"]
        lo, n = local_range(pm, 0)
        table = local(pm)[row - lo:row - lo + 1] if lo <= row < lo + n \
            else torch.full((1, pm.shape[1]), -1, dtype=pm.dtype,
                            device=local(pm).device)
        x, part = self._prefill_layers(
            params, state, tokens, (start + steps)[None], page_map=table,
            write_valid=(steps < length)[None], owner=row_owner(pm, row))
        with part.region():
            logits = whole(L.unembed(self.cfg, params,
                                     x[:, max(length - 1, 0)][:, None],
                                     part=part))
        # a fill: assigning a Python int would copy it from host memory
        local(state["pos"])[row:row + 1].fill_(start + length)
        return logits[:, 0], state

    def mount_slot_pages(self, state, row: int, pages, pos: int):
        """Write slot ``row``'s page-table row and position into a paged
        decode state, in place — the paged analog of :meth:`insert_slot`,
        used at admission, at page-boundary extension, and at retire (all
        -1 and pos 0: the row's writes drop and its reads are masked).  On
        a mesh ``pages`` are ids of the pool of the batch rank holding the
        row: only that rank writes the table row; every rank writes the
        replicated position."""
        pm = state["page_map"]
        lo, n = local_range(pm, 0)
        if lo <= row < lo + n:
            local(pm)[row - lo] = torch.as_tensor(pages, dtype=torch.int32)
        local(state["pos"])[row:row + 1].fill_(pos)
        return state
