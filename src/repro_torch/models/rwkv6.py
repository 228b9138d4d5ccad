"""RWKV-6 "Finch" — the attention-free LM with data-dependent decay —
counterpart of the JAX package's ``models/rwkv6.py``.

Token-shift ddlerp with a shared low-rank adapter, per-channel
data-dependent decay w = exp(-exp(w0 + lora)), a per-head WKV state S in
R^{dh x dh}, bonus u, group norm, silu(g) gating and a squared-relu
channel mix (arXiv:2404.05892).  The decode state is O(1) per sequence:
the last token of each mix (``shift_t``, ``shift_c``) and the WKV states.
The model has no attention heads, so the placement controller's head
plans cannot be applied to it (``serving.engine`` reports them as not
applied, as the reference does).

Parameters are a nested dict in the reference's names and stacked
``(L, ...)`` layouts (``weights.params_from_jax`` carries them unchanged);
the reference's ``lax.scan`` over layers is a Python loop over per-layer
views.  Each layer returns its new token shifts and WKV state; the decode
state takes them in place, while ``forward`` (the training path) starts
from a fresh zero state and writes nothing, so autograd's saved tensors
stay intact.  ``wkv_scan`` is the model's plain recurrence
(``use_kernel=False``); ``use_kernel=True`` runs the hand-written WKV6
kernel (``kernels.rwkv6``) through ``kernels.ops``.  ``remat``
checkpoints each layer (``transformer.remat_call``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.partitioning import (NULL, head_shard, local,
                                             local_shards, tp_degree)
from repro_torch.models.transformer import (_layer_view, check_remat,
                                           place_state, remat_call,
                                           torch_dtype)

LORA_R = 32      # shared ddlerp adapter rank
LORA_W_R = 64    # decay adapter rank
MIX_NAMES = ("w", "k", "v", "r", "g")


def wkv_scan(r, k, v, w, u, state):
    """Sequential WKV recurrence in float32.

    r,k,v,w: (B,S,H,dh); u: (H,dh); state: (B,H,dh,dh) with S[i,j]
    indexed [key channel i, value channel j], not written.  Returns y
    (B,S,H,dh) and the final state, a new tensor."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        y = torch.einsum("bhi,bhij->bhj", r_t, s)
        bonus = torch.einsum("bhi,hi,bhi->bh", r_t, u, k_t)
        ys.append(y + bonus[..., None] * v_t)
        s = w_t[..., None] * s + k_t[..., None] * v_t[:, :, None, :]
    return torch.stack(ys, dim=1), s


def group_norm_heads(y, scale, bias, eps: float = 1e-5):
    """Per-head layer norm of (B,S,H,dh); scale/bias (H*dh,).  Returns
    (B,S,H*dh) in float32."""
    B, S, H, dh = y.shape
    y32 = y.float()
    mu = y32.mean(dim=-1, keepdim=True)
    var = (y32 - mu).square().mean(dim=-1, keepdim=True)
    out = (y32 - mu) * torch.rsqrt(var + eps)
    return out.reshape(B, S, H * dh) * scale.float() + bias.float()


def _shifted(x, shift_state):
    """The previous token of every position: ``shift_state`` (B, D) — the
    last token of the previous call — then x's tokens but the last."""
    return torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)


# the reference's layout of the decode state where it constrains it: the
# WKV state's heads over "model", every leaf's batch rows over the data axes
STATE_AXES = {"shift_t": (None, "batch", None),
              "shift_c": (None, "batch", None),
              "wkv": (None, "batch", "ssm_heads", None, None)}


class RWKV6Model:
    """Config-driven RWKV-6 LM on one device or, with ``part`` (a
    partitioner on a ``DeviceMesh``), on every rank of the mesh at once.

    On a mesh the parameters are DTensors placed by
    ``placement_bridge.param_shardings`` and the decode state by
    ``decode_state_shardings`` (built shard by shard); every layer runs on
    the rank's local tensors with explicit collectives
    (``partitioning.HeadShard``): its batch rows over the data axes, and
    over "model" its WKV heads — the column shards of ``wr``/``wk``/
    ``wv``/``wg`` are exactly their channels, the decay is computed for
    those channels only, the WKV recurrence (the kernel on the card) and
    the per-head group norm run on them, the state shard is written in
    place — and its rows of ``wo`` and slice of the channel mix's d_ff,
    whose partial outputs are all-reduced; the channel mix's receptance
    gate is a column shard, gathered, so the residual stream stays whole
    over "model".  The logits come back whole on every rank."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device,
                 use_kernel: bool = False, remat: str = "none", part=NULL):
        if cfg.family != "ssm":
            raise ValueError(f"RWKV6Model serves the ssm family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        self.remat = check_remat(remat)
        self.part = part
        self.H = cfg.n_heads
        self.dh = cfg.d_model // cfg.n_heads
        if part.mesh is not None and self.H % tp_degree(part.mesh):
            raise ValueError(f"the mesh's model degree "
                             f"{tp_degree(part.mesh)} must divide the "
                             f"{self.H} WKV heads")

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights at the reference's init scales (normal draws from
        ``generator``, which must live on this model's device).  As in the
        reference, ``lora_B``, ``lw_B`` and ``u`` start at zero."""
        cfg = self.cfg
        D, F_, V, n = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
        dt, dev, g = torch_dtype(cfg.param_dtype), self.device, generator

        def dense(d_in, shape):
            return L.dense_init(g, d_in, (n,) + shape, dt, dev)

        def full(shape, value):
            return torch.full((n,) + shape, value, dtype=dt, device=dev)

        layers = {
            # time mix
            "mu_x": full((D,), 0.5),
            "mix_mu": full((5, D), 0.5),
            "lora_A": dense(D, (D, 5 * LORA_R)),
            "lora_B": full((5, LORA_R, D), 0.0),
            "w0": full((D,), -6.0),       # exp(-exp(-6)): slow decay
            "lw_A": dense(D, (D, LORA_W_R)),
            "lw_B": full((LORA_W_R, D), 0.0),
            "wr": dense(D, (D, D)),
            "wk": dense(D, (D, D)),
            "wv": dense(D, (D, D)),
            "wg": dense(D, (D, D)),
            "wo": dense(D, (D, D)),
            "u": full((self.H, self.dh), 0.0),
            "gn_scale": full((D,), 1.0),
            "gn_bias": full((D,), 0.0),
            # channel mix
            "mu_ck": full((D,), 0.5),
            "mu_cr": full((D,), 0.5),
            "wck": dense(D, (D, F_)),
            "wcv": dense(F_, (F_, D)),
            "wcr": dense(D, (D, D)),
        }
        for nm in ("ln1", "ln2"):
            layers[nm] = full((D,), 1.0)
            layers[nm + "_b"] = full((D,), 0.0)
        params = {"layers": layers,
                  "tok_embed": L.normal_init(g, (V, D), 0.02, dt, dev)}
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(g, D, (D, V), dt, dev)
        params["ln_f"] = torch.ones((D,), dtype=dt, device=dev)
        params["ln_f_b"] = torch.zeros((D,), dtype=dt, device=dev)
        return params

    # ------------------------------------------------------------- time mix
    def _time_mix(self, p, x, shift_state, wkv_state, out_state, shard):
        """x: (B,S,D); shift_state (B,D) and wkv_state (B,H,dh,dh) are this
        layer's states, not written.  Returns the output, the new token
        shift (a view of x) and the new WKV state; the kernel writes the
        latter into ``out_state`` when given.  ``shard``: this rank's WKV
        heads (``wkv_state``, ``u`` and the r/k/v/g columns hold only
        them), whose partial output is summed over "model"."""
        B, S, D = x.shape
        lo, n = shard.heads(self.H)
        cols = slice(lo * self.dh, (lo + n) * self.dh)
        dx = _shifted(x, shift_state) - x
        x_mix = x + dx * p["mu_x"]
        lora = torch.tanh(x_mix @ p["lora_A"]).reshape(B, S, 5, LORA_R)
        lora = torch.einsum("bsnr,nrd->bsnd", lora, p["lora_B"])
        mixed = x[:, :, None, :] + dx[:, :, None, :] * \
            (p["mix_mu"][None, None] + lora)                   # (B,S,5,D)
        xw, xk, xv, xr, xg = mixed.unbind(dim=2)
        r = xr @ p["wr"]
        k = xk @ p["wk"]
        v = xv @ p["wv"]
        g = xg @ p["wg"]
        # the decay of this rank's channels only
        w_log = p["w0"][cols].float() + (torch.tanh(xw @ p["lw_A"])
                                         @ p["lw_B"][:, cols]).float()
        w = torch.exp(-torch.exp(w_log))                       # (B,S,n*dh)
        r, k, v, w = (t.reshape(B, S, n, self.dh) for t in (r, k, v, w))
        if self.use_kernel:
            y, new_wkv = ops.rwkv6(r, k, v, w, p["u"], wkv_state,
                                   out_state=out_state)
        else:
            y, new_wkv = wkv_scan(r, k, v, w, p["u"], wkv_state)
        y = group_norm_heads(y, p["gn_scale"][cols], p["gn_bias"][cols])
        y = (y * F.silu(g.float())).to(x.dtype)
        return shard.reduce(y @ p["wo"]), x[:, -1], new_wkv

    def _channel_mix(self, p, x, shift_state, shard):
        """Returns the output and the new token shift (a view of x).  On a
        mesh the rank's d_ff slice gives a partial output, summed over
        "model", and its receptance columns are gathered."""
        dx = _shifted(x, shift_state) - x
        xk = x + dx * p["mu_ck"]
        xr = x + dx * p["mu_cr"]
        k = torch.square(torch.relu(xk @ p["wck"]))
        gate = shard.gather(torch.sigmoid(xr @ p["wcr"]), x.shape[-1])
        return gate * shard.reduce(k @ p["wcv"]), x[:, -1]

    def _layer(self, p, x, state, out_wkv, shard):
        """One layer from its states ``state`` (read only).  Returns the
        hidden state and the layer's new states."""
        h = L.apply_norm(self.cfg, p, "ln1", x)
        out, shift_t, wkv = self._time_mix(p, h, state["shift_t"],
                                           state["wkv"], out_wkv, shard)
        x = x + out
        h = L.apply_norm(self.cfg, p, "ln2", x)
        out, shift_c = self._channel_mix(p, h, state["shift_c"], shard)
        return x + out, {"shift_t": shift_t, "shift_c": shift_c, "wkv": wkv}

    # --------------------------------------------------------------- forward
    def _zero_state(self, rows: int, heads: int,
                    device) -> Dict[str, torch.Tensor]:
        """Zero token shifts (L, rows, D) and WKV states (L, rows, heads,
        dh, dh) float32."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        return {
            "shift_t": torch.zeros((cfg.n_layers, rows, cfg.d_model),
                                   dtype=dt, device=device),
            "shift_c": torch.zeros((cfg.n_layers, rows, cfg.d_model),
                                   dtype=dt, device=device),
            "wkv": torch.zeros((cfg.n_layers, rows, heads, self.dh,
                                self.dh), dtype=torch.float32,
                               device=device),
        }

    def _run_layers(self, params, x, state, shard, write: bool = True):
        """Loop over layers; layer l reads its slice of the stacked params
        (this rank's shards on a mesh) and of ``state`` (local tensors),
        and with ``write`` stores its new states into that slice (the
        kernel writes its WKV state there itself).  ``remat`` checkpoints
        each layer.  int8 layer weights are refused: the reference's
        ``quantize_params`` gives RWKV-6's (L, D, D) ``wk``/``wv``/``wo``
        the attention base rank 3, so their scales carry no layer axis and
        its layer scan fails on them; the port does not invent a scheme
        the reference lacks."""
        if any(L.is_quantized(v) for v in params["layers"].values()):
            raise NotImplementedError(
                "RWKV-6 takes no int8 layer weights: the reference's "
                "quantize_params gives its (L, D, D) wk/wv/wo scales "
                "without a layer axis and its forward fails on them")
        layers = {name: local(t) for name, t in params["layers"].items()}
        for l in range(self.cfg.n_layers):
            views = {name: buf[l] for name, buf in state.items()}
            out_wkv = views["wkv"] if write and self.use_kernel else None
            x, new = remat_call(self.remat, self._layer,
                                _layer_view(layers, l), x, views, out_wkv,
                                shard)
            if write:
                for name, buf in views.items():
                    if new[name] is not buf:
                        buf.copy_(new[name])
        return x

    def _run(self, params, tokens, cache):
        """Embed this rank's batch rows of ``tokens`` (B, S) and run every
        layer from ``cache`` — the decode state's, updated in place, each
        DTensor leaf held to the reference's layout (``STATE_AXES``: a
        redistributed copy would take the writes), or None: a zero state,
        written nowhere.  Returns the final-norm hidden state, the
        top-level params as local tensors and the call's split
        (``partitioning.head_shard``)."""
        B = tokens.shape[0]
        shard = head_shard(self.part, B)
        top = {k: local(v) for k, v in params.items() if k != "layers"}
        lo, n = shard.rows
        x = L.embed_rows(self.cfg, top, tokens[lo:lo + n], shard)
        if cache is None:
            x = self._run_layers(params, x, self._zero_state(
                n, shard.heads(self.H)[1], x.device), shard, write=False)
        else:
            x = self._run_layers(params, x, local_shards(
                cache, self.part.for_batch(B), STATE_AXES), shard)
        return L.apply_norm(self.cfg, top, "ln_f", x), top, shard

    def forward(self, params, tokens, **_):
        """Full-sequence forward from a zero state, written nowhere.
        Returns (logits (B,S,V), whole on every rank of a mesh, aux): the
        model has no aux loss, so aux is a float32 zero, as in the
        reference."""
        x, top, shard = self._run(params, tokens, None)
        return L.unembed_whole(self.cfg, top, x, shard), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def loss(self, params, batch):
        """Mean token cross-entropy of ``batch["labels"]``."""
        logits, _ = self.forward(params, batch["tokens"])
        return L.cross_entropy(logits, batch["labels"])

    # ---------------------------------------------------------------- decode
    def init_decode_state(self, params, batch: int, max_seq: int, **_):
        """The lock-step decode state: ``cache`` holds the per-layer token
        shifts and WKV states (O(1) in the sequence; ``max_seq`` is
        unused) and ``pos`` the batch's position.  On a mesh each rank
        builds only its shard (``transformer.place_state``)."""
        if self.part.mesh is None:
            return {"cache": self._zero_state(batch, self.H, self.device),
                    "pos": 0}
        return place_state({"cache": self._zero_state(batch, self.H, "meta"),
                            "pos": 0}, self.cfg, self.part, batch)

    def prefill(self, params, state, tokens):
        """Run the (B, S) prompts through the model from ``state``,
        updating it in place.  Returns the last token's logits (B, V),
        whole on every rank of a mesh, and the state with ``pos == S``."""
        x, top, shard = self._run(params, tokens, state["cache"])
        logits = L.unembed_whole(self.cfg, top, x[:, -1:], shard)
        state["pos"] = tokens.shape[1]
        return logits[:, 0], state

    def decode_step(self, params, state, tokens):
        """One step for every row. tokens: (B,) int.  Returns (logits
        (B, V) float32, whole on every rank of a mesh, state)."""
        x, top, shard = self._run(params, tokens[:, None], state["cache"])
        logits = L.unembed_whole(self.cfg, top, x, shard)
        state["pos"] += 1
        return logits[:, 0], state
