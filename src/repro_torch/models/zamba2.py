"""Zamba2 hybrid — a Mamba-2 backbone and one *shared* attention block —
counterpart of the JAX package's ``models/zamba2.py``.

The mamba layers form G supergroups of ``shared_attn_every`` (zamba2-2.7b:
9 of 6); the shared block (one weight copy: RMSNorm, GQA attention, RMSNorm,
SwiGLU MLP) runs at the top of every supergroup.  Each application has its
own KV cache slot, since its activations differ, so the decode cache is
(G, B, T, KvE, dh), head-sharded exactly as a dense transformer's.

Parameters are a nested dict in the reference's names and layouts: the mamba
layers stacked ``(G, g, ...)`` under ``layers``, the shared block under
``shared`` (``weights.params_from_jax`` carries both unchanged).  The
reference's two nested ``lax.scan`` become Python loops over views of the
stacked params, cache and states.  A decode state is updated in place:
supergroup g's attention writes its K/V into the view ``attn_cache[..][g]`` of
the stacked buffer, and each mamba layer's new states are copied into theirs.
``forward`` (the training path) starts from fresh zero states and writes
nothing, so autograd's saved tensors stay intact; ``remat`` checkpoints each
supergroup, as the reference's remat wraps its group body
(``transformer.remat_call``).  ``use_kernel`` runs the shared block's prefill
through the flash attention kernel and its decode through the resident decode
kernel over every q head (identity rows: one shared block, no per-layer row
maps).  There is no slot API: the model serves lock-step waves.

With ``part`` (a partitioner on a ``DeviceMesh``) the model runs on every
rank of the mesh at once, its parameters placed by
``placement_bridge.param_shardings`` and its decode state by
``decode_state_shardings`` (built shard by shard).  The residual stream
is the rank's batch rows as a local tensor: the Mamba-2 layers run on it
with explicit collectives (``mamba2.mamba_block`` with a
``partitioning.HeadShard``), each rank's conv and SSM state shards written
in place; at the top of every supergroup it becomes a DTensor of the
residual layout (``partitioning.from_local``: batch rows over the data
axes, whole over "model") for the shared block, which runs sharded as a
dense layer does (its heads' K/V in the rank's shard of the cache), and
comes back with ``local``.  The logits come back whole on every rank.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import (init_mamba_layer, mamba_block,
                                       mamba_dims, zero_mamba_state)
from repro_torch.models.partitioning import (NULL, from_local, head_shard,
                                             local, local_shards, tp_degree)
from repro_torch.models.transformer import (_layer_view, check_remat,
                                           place_state, remat_call,
                                           torch_dtype)

# the reference's layout of the Mamba-2 states where it constrains them
# (the SSM state's heads over "model"), and the conv tail's as the
# decode-state rule places it (its channels over "model"); batch rows over
# the data axes
STATE_AXES = {"ssm": (None, None, "batch", "ssm_heads", None, None),
              "conv": (None, None, "batch", None, "ssm_heads")}


class Zamba2Model:
    """Config-driven Zamba2 hybrid LM on one device or, with ``part``, on
    every rank of a mesh at once (module doc)."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device,
                 use_kernel: bool = False, remat: str = "none", tp: int = 1,
                 part=NULL):
        if cfg.family != "hybrid":
            raise ValueError(f"Zamba2Model serves the hybrid family, not "
                             f"{cfg.family!r}")
        if cfg.shared_attn_every <= 0 \
                or cfg.n_layers % cfg.shared_attn_every:
            raise ValueError(f"{cfg.n_layers} layers do not form "
                             f"supergroups of {cfg.shared_attn_every}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        self.remat = check_remat(remat)
        # the shared block's heads in the tp layout (padded query heads,
        # replicated KV heads), as a dense transformer's
        self.hd = L.head_dims(cfg, tp)
        self.n_groups = cfg.n_layers // cfg.shared_attn_every
        self.group = cfg.shared_attn_every
        self.part = part
        if part.mesh is not None:
            m, nh = tp_degree(part.mesh), mamba_dims(cfg)[1]
            if self.hd.Hp % m or self.hd.KvE % m or nh % m:
                raise ValueError(
                    f"the mesh's model degree {m} must divide the shared "
                    f"block's padded query heads ({self.hd.Hp}) and KV "
                    f"rows ({self.hd.KvE}) — build with tp a multiple of "
                    f"it — and the {nh} SSM heads")

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights at the reference's init scales (normal draws from
        ``generator``, which must live on this model's device), in its
        tree.  As in the reference, every layer's ``conv_b``, ``A_log`` and
        ``dt_bias`` start at zero and ``D`` at one."""
        cfg = self.cfg
        D, V = cfg.d_model, cfg.vocab_size
        dt, dev, g = torch_dtype(cfg.param_dtype), self.device, generator
        params = {
            "layers": init_mamba_layer(g, cfg, (self.n_groups, self.group),
                                       dt, dev),
            "shared": {"attn": L.init_attention(g, cfg, self.hd, (), dt, dev),
                       "mlp": L.init_mlp(g, cfg, (), dt, dev),
                       "ln1": torch.ones((D,), dtype=dt, device=dev),
                       "ln2": torch.ones((D,), dtype=dt, device=dev)},
            "tok_embed": L.normal_init(g, (V, D), 0.02, dt, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(g, D, (D, V), dt, dev)
        params["ln_f"] = torch.ones((D,), dtype=dt, device=dev)
        return params

    # ----------------------------------------------------------------- body
    def _shared_attn(self, params, x, positions, cache, cache_pos, part):
        cfg = self.cfg
        p = params["shared"]
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn_out, _ = L.self_attention_block(
            cfg, p["attn"], self.hd, h, positions, cache=cache,
            cache_pos=cache_pos, use_kernel=self.use_kernel, part=part)
        x = x + attn_out
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp_block(cfg, p["mlp"], h, part=part)

    def _group(self, params, layers, gi, x, positions, cache, cache_pos,
               states, part, shard):
        """Supergroup ``gi``: the shared block over its cache view, then its
        mamba layers (``layers``: the local stacks) from ``states``
        (per-layer {"conv", "ssm"}, local, read only).  On a mesh the
        local residual stream ``x`` crosses into a DTensor for the shared
        block and back.  Returns the hidden state and the layers' new
        states."""
        if part.mesh is None:
            x = self._shared_attn(params, x, positions, cache, cache_pos,
                                  part)
        else:
            B, S, D = positions.shape + (x.shape[-1],)
            x = from_local(x, part.sharding(("batch", "seq", "d_model")),
                           (B, S, D))
            x = local(self._shared_attn(params, x, positions, cache,
                                        cache_pos, part))
        new_states = []
        for j, lst in enumerate(states):
            out, new = mamba_block(self.cfg, _layer_view(layers, (gi, j)),
                                   x, lst, shard)
            new_states.append(new)
            x = x + out
        return x, new_states

    def _run(self, params, tokens, start, state, cache_pos,
             write: bool = True):
        """Embed this rank's batch rows of ``tokens`` (B, S) at positions
        from ``start`` and run every supergroup.  state: {"attn_cache":
        {"k", "v"} (G, B, T, KvE, dh) or None, "mamba": {"conv", "ssm"}
        (G, g, B, ...)}, updated in place through per-supergroup and
        per-layer views when ``write``; on a mesh its DTensor leaves are
        the rank's shards, the Mamba-2 states held to the reference's
        layout (``STATE_AXES``: a redistributed copy would take the
        writes).  Returns the final-norm hidden state of the rank's rows,
        the top-level params as local tensors and the call's split
        (``partitioning.head_shard``)."""
        B, S = tokens.shape
        part = self.part.for_batch(B)
        shard = head_shard(self.part, B)
        # an int8 leaf's q8 and sc to their local shards too
        top = {k: ({n: local(t) for n, t in v.items()}
                   if isinstance(v, dict) else local(v))
               for k, v in params.items() if k not in ("layers", "shared")}
        lo, n = shard.rows
        x = L.embed_rows(self.cfg, top, tokens[lo:lo + n], shard)
        pos = torch.arange(start, start + S, dtype=torch.int32,
                           device=x.device)[None].expand(B, S)
        attn_cache, mamba = state["attn_cache"], state["mamba"]
        with part.region():
            if part.mesh is not None:
                pos = part.shard(pos, ("batch", "seq"))
                mamba = local_shards(mamba, part, STATE_AXES)
            layers = {k: local(v) for k, v in params["layers"].items()}
            for gi in range(self.n_groups):
                cache = None if attn_cache is None else \
                    {name: buf[gi] for name, buf in attn_cache.items()}
                views = [{name: buf[gi, j] for name, buf in mamba.items()}
                         for j in range(self.group)]
                x, new_states = remat_call(
                    self.remat, self._group, params, layers, gi, x, pos,
                    cache, cache_pos, views, part, shard)
                if write:
                    for lst, new in zip(views, new_states):
                        for name, buf in lst.items():
                            buf.copy_(new[name])
        return L.rms_norm(x, top["ln_f"], self.cfg.norm_eps), top, shard

    def _zero_state(self, batch: int, max_seq: int, with_cache: bool,
                    device):
        cfg, hd = self.cfg, self.hd
        mamba = zero_mamba_state(cfg, batch, (self.n_groups, self.group),
                                 device=device)
        attn_cache = None
        if with_cache:
            shape = (self.n_groups, batch, max_seq, hd.KvE, hd.dh)
            attn_cache = {n: torch.zeros(shape, dtype=torch_dtype(cfg.dtype),
                                         device=device)
                          for n in ("k", "v")}
        return {"attn_cache": attn_cache, "mamba": mamba}

    # --------------------------------------------------------------- forward
    def forward(self, params, tokens, **_):
        """Full-sequence forward from a zero state, written nowhere.
        Returns (logits (B, S, V) float32, whole on every rank of a mesh,
        aux): the model has no aux loss, so aux is a float32 zero, as in
        the reference.  On a mesh the zero Mamba-2 states are the rank's
        shards only."""
        B = tokens.shape[0]
        shard = head_shard(self.part, B)
        state = {"attn_cache": None, "mamba": zero_mamba_state(
            self.cfg, shard.rows[1], (self.n_groups, self.group),
            device=self.device, shard=shard)}
        x, top, shard = self._run(params, tokens, 0, state, None,
                                  write=False)
        return L.unembed_whole(self.cfg, top, x, shard), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def loss(self, params, batch):
        """Mean token cross-entropy of ``batch["labels"]``."""
        logits, _ = self.forward(params, batch["tokens"])
        return L.cross_entropy(logits, batch["labels"])

    # ---------------------------------------------------------------- decode
    def init_decode_state(self, params, batch: int, max_seq: int, **_):
        """The lock-step decode state: ``cache`` holds the (G, B, max_seq,
        KvE, dh) attention cache and the (G, g, ...) mamba states, ``pos``
        the batch's position.  On a mesh each rank builds only its shard
        (``transformer.place_state``)."""
        if self.part.mesh is None:
            return {"cache": self._zero_state(batch, max_seq, True,
                                              self.device), "pos": 0}
        return place_state({"cache": self._zero_state(batch, max_seq, True,
                                                      "meta"), "pos": 0},
                           self.cfg, self.part, batch)

    def prefill(self, params, state, tokens):
        """Run the (B, S) prompts from position 0, writing the cache and the
        mamba states in place.  Returns the last token's logits (B, V),
        whole on every rank of a mesh, and the state with ``pos == S``."""
        x, top, shard = self._run(params, tokens, 0, state["cache"], 0)
        logits = L.unembed_whole(self.cfg, top, x[:, -1:], shard)
        state["pos"] = tokens.shape[1]
        return logits[:, 0], state

    def decode_step(self, params, state, tokens):
        """One step for every row at the batch's position. tokens: (B,)
        int.  Returns (logits (B, V) float32, whole on every rank of a
        mesh, state)."""
        pos = state["pos"]
        x, top, shard = self._run(params, tokens[:, None], pos,
                                  state["cache"], pos)
        logits = L.unembed_whole(self.cfg, top, x, shard)
        state["pos"] = pos + 1
        return logits[:, 0], state
