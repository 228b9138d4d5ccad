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
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import (init_mamba_layer, mamba_block,
                                       zero_mamba_state)
from repro_torch.models.transformer import (_layer_view, check_remat,
                                           remat_call, torch_dtype)


class Zamba2Model:
    """Config-driven Zamba2 hybrid LM on one device."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device,
                 use_kernel: bool = False, remat: str = "none", tp: int = 1):
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
    def _shared_attn(self, params, x, positions, cache, cache_pos):
        cfg = self.cfg
        p = params["shared"]
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn_out, _ = L.self_attention_block(
            cfg, p["attn"], self.hd, h, positions, cache=cache,
            cache_pos=cache_pos, use_kernel=self.use_kernel)
        x = x + attn_out
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp_block(cfg, p["mlp"], h)

    def _group(self, params, gi, x, positions, cache, cache_pos, states):
        """Supergroup ``gi``: the shared block over its cache view, then its
        mamba layers from ``states`` (per-layer {"conv", "ssm"}, read only).
        Returns the hidden state and the layers' new states."""
        x = self._shared_attn(params, x, positions, cache, cache_pos)
        new_states = []
        for j, lst in enumerate(states):
            out, new = mamba_block(
                self.cfg, _layer_view(params["layers"], (gi, j)), x, lst)
            new_states.append(new)
            x = x + out
        return x, new_states

    def _run(self, params, x, positions, state, cache_pos,
             write: bool = True):
        """state: {"attn_cache": {"k", "v"} (G, B, T, KvE, dh) or None,
        "mamba": {"conv", "ssm"} (G, g, B, ...)}, updated in place through
        per-supergroup and per-layer views when ``write``."""
        attn_cache, mamba = state["attn_cache"], state["mamba"]
        for gi in range(self.n_groups):
            cache = None if attn_cache is None else \
                {n: buf[gi] for n, buf in attn_cache.items()}
            views = [{n: buf[gi, j] for n, buf in mamba.items()}
                     for j in range(self.group)]
            x, new_states = remat_call(self.remat, self._group, params, gi,
                                       x, positions, cache, cache_pos, views)
            if write:
                for lst, new in zip(views, new_states):
                    for n, buf in lst.items():
                        buf.copy_(new[n])
        return x

    def _zero_state(self, batch: int, max_seq: int, with_cache: bool):
        cfg, hd = self.cfg, self.hd
        mamba = zero_mamba_state(cfg, batch, (self.n_groups, self.group),
                                 device=self.device)
        attn_cache = None
        if with_cache:
            shape = (self.n_groups, batch, max_seq, hd.KvE, hd.dh)
            attn_cache = {n: torch.zeros(shape, dtype=torch_dtype(cfg.dtype),
                                         device=self.device)
                          for n in ("k", "v")}
        return {"attn_cache": attn_cache, "mamba": mamba}

    def _positions(self, B: int, start: int, S: int):
        pos = torch.arange(start, start + S, dtype=torch.int32,
                           device=self.device)
        return pos[None].expand(B, S)

    def _logits(self, params, x):
        x = L.rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return L.unembed(self.cfg, params, x)

    # --------------------------------------------------------------- forward
    def forward(self, params, tokens, **_):
        """Full-sequence forward from a zero state, written nowhere.
        Returns (logits (B, S, V) float32, aux): the model has no aux loss,
        so aux is a float32 zero, as in the reference."""
        B, S = tokens.shape
        x = L.embed(self.cfg, params, tokens)
        x = self._run(params, x, self._positions(B, 0, S),
                      self._zero_state(B, S, with_cache=False), None,
                      write=False)
        return self._logits(params, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def loss(self, params, batch):
        """Mean token cross-entropy of ``batch["labels"]``."""
        logits, _ = self.forward(params, batch["tokens"])
        return L.cross_entropy(logits, batch["labels"])

    # ---------------------------------------------------------------- decode
    def init_decode_state(self, params, batch: int, max_seq: int, **_):
        """The lock-step decode state: ``cache`` holds the (G, B, max_seq,
        KvE, dh) attention cache and the (G, g, ...) mamba states, ``pos``
        the batch's position."""
        return {"cache": self._zero_state(batch, max_seq, with_cache=True),
                "pos": 0}

    def prefill(self, params, state, tokens):
        """Run the (B, S) prompts from position 0, writing the cache and the
        mamba states in place.  Returns the last token's logits (B, V) and
        the state with ``pos == S``."""
        B, S = tokens.shape
        x = L.embed(self.cfg, params, tokens)
        x = self._run(params, x, self._positions(B, 0, S), state["cache"], 0)
        logits = self._logits(params, x[:, -1:])
        state["pos"] = S
        return logits[:, 0], state

    def decode_step(self, params, state, tokens):
        """One step for every row at the batch's position. tokens: (B,)
        int.  Returns (logits (B, V) float32, state)."""
        pos = state["pos"]
        x = L.embed(self.cfg, params, tokens[:, None])
        x = self._run(params, x, self._positions(tokens.shape[0], pos, 1),
                      state["cache"], pos)
        logits = self._logits(params, x)
        state["pos"] = pos + 1
        return logits[:, 0], state
