"""Serving engines with the paper's controller in the loop — counterpart of
the JAX package's ``serving/engine.py``.  Two schedulers over one model and
controller stack:

``ServingEngine`` (continuous batching)
  A persistent ``(n_slots, max_seq)`` KV cache with per-slot positions.  Any
  queued request is admitted into any free slot the moment one frees: the
  prompt is right-padded to a power-of-two bucket, prefilled at batch 1,
  and copied into the slot's cache row (``insert_slot``).  Decode runs one
  step for the whole batch with per-slot attention masking.  ``paged=True``
  swaps the dense cache for a pool of pages shared by a group's slots
  (``serving.paging``): admission reserves a request's worst-case pages,
  pages are handed out as decode advances and freed at retire, and prefill
  runs in fixed-size chunks.  ``kv_quant`` configs keep the cache (dense or
  paged) in int8 with per-(token, head) scales.  ``pipeline_k=K`` splits
  the slots into K contiguous groups with a decode state (and a page pool)
  each; a scheduler step decodes one group, so K tokens are in flight
  across the layer stages the controller places.

``WaveServingEngine`` (the static scheduler)
  Up to ``n_slots`` equal-length prompts form a wave; the wave prefills as
  one batch and decodes in lock-step until every request finishes.  It is
  the scheduler of sliding-window archs served to their window, whose ring
  cache takes one position for the whole batch, and of the attention-free
  RWKV-6, which has no slot API (``make_engine`` picks it for both).

Every λ generated tokens (λ·pipeline_k scheduler steps) the
``IntervalController`` observes step-time
telemetry (and the per-slot cache occupancy), re-runs Algorithm 1 on the
per-(layer, head) block graph — with one block per (layer, expert) for MoE
archs, priced by the decode state's router loads — and the engine applies
the resulting per-layer head permutations to the live KV cache AND the
weights between steps (``_migrate_state``), and the expert-row
permutations to the stacked expert weights (``_migrate_experts``).  With
``use_kernel=True`` decode attention runs the hand-written flash-decode
kernel of the cache's kind; the continuous engine rebuilds its gather maps
from each plan (``_refresh_head_rows``).

The VLM (llama-3.2-vision) serves on ``ServingEngine``: a request
carries its image patch embeddings (``submit(img_embeds=)``), right-padded
into a slot's buffer of ``img_tokens`` rows, projected at prefill into the
request's image K/V and spliced into its slot with the cache.

Device churn (``ServingEngine``): ``fail_device`` applies the controller's
evacuation plan and rebuilds every in-flight stream's cache by
teacher-forced replay through admission's own prefill helpers and the
decode step, so streams do not change; ``rejoin_device`` applies an
expansion plan; ``slow_device`` pins load the next interval observes;
``request_replan`` fires the interval on the next step.

The controller drives a simulated device network, as in the reference: the
model runs on one GPU (or the CPU), and the placement decides which
(layer, head) rows and experts each simulated device holds.  With a
partitioner on a ``DeviceMesh`` (``part``; every family) the engine runs
on every rank of the mesh at once: each rank holds its shard of the
weights (a MoE arch's experts over "pod") and its heads' shard of the KV
cache (linear or ring; a VLM's image K/V too; a paged store is its batch
rank's own pool, with an allocator for each (slot group, batch rank)
kept on every rank) or of the recurrent state
(WKV, SSM and conv), runs the same scheduler and controller
from the same seed (so every rank's plans and logs are equal, and none is
broadcast), samples from whole logits, and a migration moves only the KV,
weight and expert rows that change rank between ranks.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import CostModel
from repro_torch.core.controller import ControllerConfig, IntervalController
from repro_torch.core.network import DeviceNetwork
from repro_torch.core.placement_bridge import (apply_layer_head_perms,
                                               head_row_maps,
                                               identity_head_rows,
                                               param_shardings,
                                               permute_model_experts_layers,
                                               permute_model_heads_layers,
                                               relative_perms)
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.models.moe import expert_identity
from repro_torch.models.partitioning import (NULL, Sharding, dp_degree,
                                             is_dtensor, local_extent,
                                             local_head_rows, mesh_device,
                                             place, placements, whole)
from repro_torch.models.transformer import torch_dtype
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.serving.paging import PagedKVAllocator
from repro_torch.tree import flatten, map_with_path


class UnsupportedArchError(NotImplementedError):
    """Raised at engine construction for configurations the slot-level
    scheduler cannot serve — never mid-serve."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (L0,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    img: Optional[np.ndarray] = None       # (I, D) VLM patch embeddings
    img_mask: Optional[np.ndarray] = None  # (I,) bool


def supports_continuous(cfg: ModelConfig,
                        max_seq: Optional[int] = None) -> Optional[str]:
    """None when ``cfg`` can run the slot-level scheduler, else the reason
    it cannot (config-only, so ``make_engine`` decides before building
    params).  A sliding-window arch keeps a ring cache when the served
    extent reaches its window, and the ring takes one position for the
    whole batch; served with ``max_seq`` below the window its cache stays
    linear and the slot scheduler applies.  ``max_seq=None`` (extent not
    known yet) gets the conservative reject."""
    if cfg.family in ("ssm", "hybrid"):
        return f"{cfg.family} archs have no prefill_bucketed/insert_slot API"
    if cfg.sliding_window and (max_seq is None
                               or max_seq >= cfg.sliding_window):
        return ("continuous batching needs a linear KV cache, not a ring; "
                f"serve with max_seq < sliding_window "
                f"({cfg.sliding_window}) to keep the cache linear")
    return None


def default_buckets(max_seq: int, lo: int = 8) -> List[int]:
    """Power-of-two prompt buckets up to ``max_seq``."""
    out, b = [], lo
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return sorted(set(out))


def _place_params(params: Dict[str, Any], cfg: ModelConfig, mesh,
                  injected: bool) -> Dict[str, Any]:
    """``params`` placed on ``mesh`` as ``param_shardings`` says (each rank
    keeps its slice; DTensor leaves keep theirs).  Migrations permute the
    placed weights in place, so an injected leaf is copied first: its
    slice on a one-device mesh, or an injected DTensor, would be the
    caller's own storage."""
    shardings = flatten(param_shardings(params, cfg, mesh))

    def one(path, leaf):
        if injected:
            leaf = leaf.clone()
        return leaf if is_dtensor(leaf) else place(leaf, shardings[path])
    return map_with_path(one, params)


def _own_expert_rows(params: Dict[str, Any], cfg: ModelConfig,
                     injected: bool) -> Dict[str, Any]:
    """The params with identity physical-expert maps (``owner``/``share``)
    installed on an MoE stack that has none: expert migrations permute the
    weight rows AND these maps, and the combine scatters rows back into
    logical order (``models.moe``), so installing identity is a bit-exact
    no-op until the first expert migration.  Migrations permute the
    stacks in place, so injected expert stacks are cloned: the caller's
    tensors never move.  The caller's dicts are not modified."""
    layers = params.get("layers")
    if not (cfg.is_moe and isinstance(layers, dict) and "moe" in layers):
        return params
    moe = dict(layers["moe"])
    if injected:
        for name in ("w_gate", "w_up", "w_down", "owner", "share"):
            if name in moe:
                moe[name] = moe[name].clone()
    if "owner" not in moe:
        moe["owner"], moe["share"] = expert_identity(
            cfg.n_experts, cfg.n_layers, device=moe["w_gate"].device)
    return dict(params, layers=dict(layers, moe=moe))


class _EngineBase:
    """Model, weights and controller wiring, intake, the sampler, and the
    interval machinery (observe -> Algorithm 1 -> migrate heads and expert
    rows) shared by both schedulers.

    ``device`` is where the model runs (``None``: the GPU, raising when
    none is present).  ``params`` injects weights in the model's layout
    (for example ``weights.params_from_jax`` of the reference's); without
    it the model draws random weights from ``seed``.  Expert migrations
    permute the engine's expert stacks in place; injected ones are cloned
    first.

    ``cost_cfg`` prices the controller's placements at another config's
    widths (the production one while a reduced model serves).
    ``layer_mode="graph"`` places the per-layer block graph of the served
    model's depth, one head permutation per layer; ``"columns"`` places
    one column per head over ``cost_cfg``'s layers, one permutation for
    every layer.

    ``tp`` builds the model in the tensor-parallel head layout of that
    degree (``layers.head_dims``): padded query heads, and for ``tp`` >
    n_kv_heads each KV head replicated ``rep`` times in the cache.  A
    migration then moves each supergroup of ``Hp // Kp`` query heads with
    its KV head's ``rep`` cache rows; without ``net`` the controller
    places over ``max(tp, 4)`` simulated devices, as the reference's.

    ``part`` (``partitioning.Partitioner`` with a mesh; every family)
    serves sharded: the model is built with it, the weights are
    placed by ``placement_bridge.param_shardings`` (injected ones copied
    first, as migrations permute the placed weights in place; a MoE
    arch's expert stacks over "pod" where the mesh has one, with the
    ``owner``/``share`` maps replicated) and the decode states by
    ``decode_state_shardings``; every rank of the mesh runs the engine
    with the same arguments and agrees on each step's time, so the
    controller's plans match across ranks.  ``exchange_log`` records, per
    applied migration, the rows and bytes this rank sent to others: KV
    rows, attention weight rows and expert rows (each a d_ff slice)."""

    def __init__(self, cfg: ModelConfig, *, n_slots: int = 4,
                 max_seq: int = 512, lam: int = 16, seed: int = 0,
                 net: Optional[DeviceNetwork] = None,
                 cost_cfg: Optional[ModelConfig] = None, greedy: bool = True,
                 layer_mode: str = "graph", use_kernel: bool = False,
                 search: str = "rescoring",
                 params: Optional[Dict[str, Any]] = None, device=None,
                 pipeline_k: int = 1, cost_page_size: int = 0, tp: int = 1,
                 part=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.use_kernel = use_kernel
        # decode tokens in flight across slot groups (ServingEngine); the
        # controller's objective becomes D_pipe(K) + D_mig, and with
        # search="bottleneck" its plans come from the bottleneck search
        self.pipeline_k = max(1, int(pipeline_k))
        self.part = part or NULL
        self.model = build_model(cfg, tp=tp, part=self.part,
                                 use_kernel=use_kernel, device=self.device)
        injected = params is not None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        if self.part.mesh is not None:
            # the identity expert maps first, so that they are placed
            # (replicated) with the rest; placing copies injected leaves
            self.params = _place_params(_own_expert_rows(params, cfg, False),
                                        cfg, self.part.mesh, injected)
        else:
            self.params = _own_expert_rows(params, cfg, injected)
        self.exchange_log: List[dict] = []
        # non-greedy sampling draws from its own seeded generator
        self._sample_gen = torch.Generator(
            device=self.device).manual_seed(seed + 0x5EED)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._rid = 0
        # per-token stream hook: ``token_sink(req, tok, done)`` fires on
        # every generated token (done=False) and once at retire
        # (tok=None, done=True).  None changes nothing.
        self.token_sink: Optional[Callable[[Request, Optional[int], bool],
                                           None]] = None
        self._load_mark_step = 0
        self._load_mark_rid = 0
        # controller wiring: Table I, incremental decode, priced at
        # cost_cfg's widths over the served depth ("graph") or cost_cfg's
        # depth ("columns")
        self.net = net or DeviceNetwork.sample(max(tp, 4), seed=seed + 1)
        # an attention-free model (RWKV-6) has no ``hd``: the controller
        # still places cfg.n_heads blocks per layer, and its plans are
        # logged as not applied (``_migrate_state``)
        hd = getattr(self.model, "hd", None)
        n_heads = cfg.n_heads if hd is None else hd.Hp
        heads_per_slot = max(1, n_heads // self.net.n_devices)
        # MoE archs: the controller places per-expert blocks (router-load-
        # weighted compute, weight-only migration bytes) when the expert
        # count tiles the devices; otherwise the cost model stays expert-
        # oblivious (one ffn block) rather than emitting perms that cannot
        # be applied to the weight stacks
        n_exp = cfg.n_experts if (cfg.is_moe and cfg.n_experts >= 2
                                  and cfg.n_experts
                                  % self.net.n_devices == 0) else 0
        ccfg = cost_cfg or cfg
        n_l = cfg.n_layers if layer_mode == "graph" else ccfg.n_layers
        self.cost = CostModel(d_model=ccfg.d_model, n_heads=cfg.n_heads,
                              L0=8, n_layers=n_l, lam=lam,
                              compute_mode="incremental",
                              layer_mode=layer_mode, n_experts=n_exp,
                              d_ff=ccfg.d_ff if n_exp else 0,
                              page_size=cost_page_size)
        # GQA stacks migrate whole KV groups: group-consistent perms.  With
        # replicated KV (rep > 1) the unit is the supergroup Hp // Kp, all
        # query heads of one unreplicated KV head, so the Kp-row KV weights
        # stay permutable and the KvE cache rows follow (``rep``); for
        # rep == 1 it is Hp // KvE
        group = 1 if hd is None else hd.Hp // hd.Kp
        if group > 1 and ((self.net.n_devices * heads_per_slot) % group
                          or cfg.n_heads % group):
            raise UnsupportedArchError(
                f"{cfg.name}: KV group size {group} does not tile the "
                f"{self.net.n_devices}x{heads_per_slot} head-slot geometry "
                f"— pick a device count whose head positions are a "
                f"multiple of the group size")
        self.controller = IntervalController(
            cfg.n_heads, self.cost, self.net,
            ControllerConfig(lam=lam, heads_per_slot=heads_per_slot,
                             group_size=group, pipeline_k=self.pipeline_k,
                             search=search))
        self.monitor = HeartbeatMonitor(self.net.n_devices)
        self.lam = lam
        self.decode_steps = 0
        self.migration_log: List[dict] = []
        # host-clock telemetry: seconds per decode step (ends in a device
        # sync) and per controller interval (Algorithm 1 + migration)
        self.step_times: List[float] = []
        self.interval_times: List[float] = []

    # ---------------------------------------------------------------- intake
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        req = Request(self._rid, np.asarray(prompt, np.int32),
                      max_new_tokens, t_submit=time.monotonic())
        self._rid += 1
        self.queue.append(req)
        return req.rid

    # --------------------------------------------------------------- sampler
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Next tokens, on the device: greedy argmax, else a draw from
        the softmax with the engine's seeded generator."""
        if self.greedy:
            return logits.argmax(dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self._sample_gen
                                 )[:, 0].cpu().numpy()

    def _sync(self):
        """Wait for the device (host-clock timings end here)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -------------------------------------------------------------- streaming
    def _emit_token(self, req: Request, tok: int):
        """Append one generated token and fire the stream hook — the one
        place tokens enter a request."""
        req.out_tokens.append(tok)
        if self.token_sink is not None:
            self.token_sink(req, tok, False)

    def _emit_done(self, req: Request):
        if self.token_sink is not None:
            self.token_sink(req, None, True)

    # ------------------------------------------------------------- telemetry
    def _record_step(self, dt: float):
        if self.part.mesh is not None:
            dt = self._slowest(dt)
        self.step_times.append(dt)
        # only live devices heartbeat: a failed device stays silent (its
        # availability estimate pinned at zero) until it rejoins
        for j in self.net.active_ids:
            self.monitor.record_step(j, dt)

    def _slowest(self, dt: float) -> float:
        """The slowest rank's step time, the same on every rank of the
        mesh (one scalar all-reduce a mesh dimension): the controller reads
        step times, and its plans must not differ between ranks."""
        import torch.distributed as dist
        mesh = self.part.mesh
        t = torch.tensor([dt], dtype=torch.float64, device=mesh_device(mesh))
        for m in range(mesh.ndim):
            if mesh.size(m) > 1:
                dist.all_reduce(t, op=dist.ReduceOp.MAX,
                                group=mesh.get_group(m))
        return float(t.item())

    def _load_signal(self) -> tuple:
        """(arrivals per scheduler step, queue depth) since the last
        interval; resets the marks."""
        steps = self.decode_steps - self._load_mark_step
        arrived = self._rid - self._load_mark_rid
        self._load_mark_step = self.decode_steps
        self._load_mark_rid = self._rid
        return arrived / max(steps, 1), len(self.queue)

    # --------------------------------------------------------------- interval
    def _interval_plan(self, tau_tokens: Optional[float] = None) -> dict:
        """Observe -> Algorithm 1: one migration plan per interval."""
        self.net.step_background_load()
        self.controller.observe_monitor(self.monitor,
                                        peak_flops=self.net.compute_avail)
        rate, depth = self._load_signal()
        return self.controller.step_interval(tau=self._tau_of(tau_tokens),
                                             arrival_rate=rate,
                                             queue_depth=depth)

    def _tau_of(self, tau_tokens: Optional[float]) -> Optional[int]:
        """Occupancy (tokens) -> interval index τ of the cost model (None:
        the controller advances its own τ by one)."""
        if tau_tokens is None:
            return None
        return max(1, round((tau_tokens - self.cost.L0)
                            / max(self.cost.lam, 1)))

    def _migrate_state(self, state: Dict[str, Any], plan,
                       permute_params: bool = True) -> tuple:
        """Execute ``plan`` physically: permute the weights AND the cache of
        ``state`` by the same group-consistent per-layer head permutations
        (row l of the plan's perms is layer l; the cache's leading axis is
        the layer stack); a ``"columns"`` controller's one row permutes
        every layer.  Attention is permutation-equivariant over heads
        (GQA: over whole KV groups) within each layer, so the model
        function is unchanged while the placement moves.  A ring's slot
        positions have no head axis and stay.  A VLM's (G, 4, ...) stacks
        have no leading layer axis, so, as in the reference, only a plan
        equal for every layer applies there: one permutation of every self
        and cross layer's weights, the cache and the image K/V.  Returns
        (applied, reason): a model without attention heads, a state whose
        cache has no "k" (zamba2's {"attn_cache", "mamba"}), or a VLM given
        a per-layer plan, applies nothing, permutes nothing, and says so.

        ``permute_params=False`` skips the shared weights: an engine with
        one decode state per in-flight group permutes them once a plan."""
        hd = getattr(self.model, "hd", None)
        if hd is None:
            return False, "model has no addressable attention heads"
        cache = state.get("cache")
        if not (isinstance(cache, dict) and "k" in cache
                and cache["k"].dim() >= 4):
            return False, "state has no addressable KV cache"
        G = hd.Hp // hd.Kp
        rel = relative_perms(plan["prev_perms"], plan["perms"])
        if getattr(self.model, "is_vlm", False):
            return self._migrate_vlm_state(state, rel, G, permute_params)
        if rel.shape[0] != self.cfg.n_layers:
            rel = np.repeat(rel, self.cfg.n_layers, axis=0)
        # on a mesh the rows that change rank move between ranks; what this
        # rank sent is counted apart for the weights and the cache
        sent_w: Dict[str, int] = {}
        sent_kv: Dict[str, int] = {}
        if permute_params:
            self.params = permute_model_heads_layers(
                self.params, rel, group_size=G, sent=sent_w)
        # the head axis is -2 of the values of a dense (L, B, T, KvE, dh)
        # cache, a ring and a paged (L, n_pages + 1, P, KvE, dh) store
        # alike, and -1 of int8 scales; each KV head's rep replicas move
        # with it
        cache["k"], cache["v"] = apply_layer_head_perms(
            cache["k"], cache["v"], rel, head_axis=-2, group_size=G,
            rep=hd.rep, sent=sent_kv)
        if "k_sc" in cache:
            cache["k_sc"], cache["v_sc"] = apply_layer_head_perms(
                cache["k_sc"], cache["v_sc"], rel, head_axis=-1,
                group_size=G, rep=hd.rep, sent=sent_kv)
        if self.part.mesh is not None:
            self._log_exchange(kv_rows=sent_kv.get("rows", 0),
                               kv_bytes=sent_kv.get("bytes", 0),
                               weight_rows=sent_w.get("rows", 0),
                               weight_bytes=sent_w.get("bytes", 0))
        return True, None

    def _migrate_vlm_state(self, state: Dict[str, Any], rel: np.ndarray,
                           G: int, permute_params: bool) -> tuple:
        """The reference's one-layout branch: a plan whose rows are all
        equal permutes the head axis of every self and cross layer's
        weights, of the (G, 4, B, T, KvE, dh) cache (and int8 scales) and
        of the image K/V (G, B, I, KvE, dh) by its one row, broadcast over
        each stack's leading layer axes ((G, 4) self, (G,) cross).  On a
        mesh the sharded weights, cache and image K/V are permuted in
        place, each rank sending only the rows that change rank
        (``placement_bridge._permute_layers_``); ``exchange_log`` counts
        the image K/V's rows with the cache's KV rows."""
        if rel.shape[0] > 1 and not np.all(rel == rel[0]):
            return False, ("per-layer plan on a cache without a leading "
                           "layer axis")
        n_g, H = self.model.n_groups, rel.shape[1]
        rows = {"layers": np.broadcast_to(rel[0], (n_g, 4, H)).copy(),
                "cross_layers": np.broadcast_to(rel[0], (n_g, H)).copy()}
        sent_w: Dict[str, int] = {}
        sent_kv: Dict[str, int] = {}
        if permute_params:
            self.params = dict(self.params, **{
                name: permute_model_heads_layers(
                    self.params[name], r, group_size=G, sent=sent_w)
                for name, r in rows.items()})
        rep = self.model.hd.rep
        for buf, r in ((state["cache"], rows["layers"]),
                       (state["img_kv"], rows["cross_layers"])):
            buf["k"], buf["v"] = apply_layer_head_perms(
                buf["k"], buf["v"], r, head_axis=-2, group_size=G, rep=rep,
                sent=sent_kv)
        cache = state["cache"]
        if "k_sc" in cache:
            cache["k_sc"], cache["v_sc"] = apply_layer_head_perms(
                cache["k_sc"], cache["v_sc"], rows["layers"], head_axis=-1,
                group_size=G, rep=rep, sent=sent_kv)
        if self.part.mesh is not None:
            self._log_exchange(kv_rows=sent_kv.get("rows", 0),
                               kv_bytes=sent_kv.get("bytes", 0),
                               weight_rows=sent_w.get("rows", 0),
                               weight_bytes=sent_w.get("bytes", 0))
        return True, None

    def _feed_expert_loads(self, states: Sequence[Dict[str, Any]]):
        """Average the decode states' router-load EWMAs ((L, E)
        routed-token fractions), normalize rows to sum 1, and hand them to
        the controller's expert cost model.  No-op for expert-oblivious
        cost models.  On a mesh a load's layers are sharded over the data
        axes: every rank reads the whole (one small gather each)."""
        if not self.cost.n_experts:
            return
        loads = [whole(st["expert_load"]).cpu().numpy() for st in states
                 if "expert_load" in st]
        if not loads:
            return
        rows = np.mean(loads, axis=0)
        rows = rows / np.maximum(rows.sum(axis=-1, keepdims=True), 1e-9)
        self.controller.update_expert_loads(rows)

    def _migrate_experts(self, plan) -> tuple:
        """Execute the plan's expert migrations physically: permute the
        w_gate/w_up/w_down expert rows (and the owner/share maps that ride
        with them) by the per-layer relative permutations, in place —
        weight-only, as head migrations permute cache rows.  On a mesh
        whose "pod" holds the experts, rows that change rank move between
        ranks, each rank sending its d_ff slice of them; the rows and
        bytes it sent join this step's ``exchange_log`` entry.  Returns
        (applied, reason)."""
        if plan.get("prev_expert_perms") is None \
                or not plan.get("expert_migrations"):
            return False, None
        moe = self.params.get("layers", {}).get("moe")
        if moe is None or "owner" not in moe:
            return False, "params carry no physical expert rows"
        rel = relative_perms(plan["prev_expert_perms"], plan["expert_perms"])
        n = int(moe["owner"].shape[0])
        if rel.shape[0] == 1:
            rel = np.broadcast_to(rel, (n, rel.shape[1]))
        if rel.shape[0] != n:
            return False, ("expert plan rows do not match the stacked "
                           "expert weights")
        sent: Dict[str, int] = {}
        self.params = permute_model_experts_layers(self.params, rel,
                                                   sent=sent)
        if self.part.mesh is not None:
            self._log_exchange(expert_rows=sent.get("rows", 0),
                               expert_bytes=sent.get("bytes", 0))
        return True, None

    def _log_exchange(self, **sent):
        """Add what this rank sent in this step's migrations to its
        ``exchange_log`` entry (one a step: KV, attention weight and
        expert rows and bytes)."""
        if not self.exchange_log \
                or self.exchange_log[-1]["step"] != self.decode_steps:
            self.exchange_log.append(dict(
                step=self.decode_steps, kv_rows=0, kv_bytes=0,
                weight_rows=0, weight_bytes=0, expert_rows=0,
                expert_bytes=0))
        entry = self.exchange_log[-1]
        for key, n in sent.items():
            entry[key] += n

    # ------------------------------------------------- migration pricing
    def _live_cache_tokens(self) -> int:
        """KV tokens a migration moves, summed over slots: the full
        reserved ``n_slots × max_seq`` extent per kv row (the paged engine
        counts its allocated pages instead)."""
        return self.n_slots * self.max_seq

    def _migration_bytes(self, pairs) -> int:
        """Bytes the plan's head migrations move through the cache: one
        k+v row over the live token extent per distinct migrated
        (layer, kv group), times its ``rep`` replicated rows, + f32 scales
        for int8 KV; 0 for a model without attention heads."""
        hd = getattr(self.model, "hd", None)
        if hd is None or not pairs:
            return 0
        G = hd.Hp // hd.Kp
        kv_moves = {(l, h // G) for (l, h, _s, _d) in pairs}
        tokens = self._live_cache_tokens()
        if self.cfg.kv_quant:
            per_row = tokens * 2 * (hd.dh + 4)   # int8 k+v + f32 scales
        else:
            per_row = tokens * 2 * hd.dh * \
                torch_dtype(self.cfg.dtype).itemsize
        return int(len(kv_moves) * hd.rep * per_row)

    def _expert_migration_bytes(self, pairs) -> int:
        """Bytes the plan's expert migrations move: 3·D·F weights per
        distinct migrated (layer, expert row) — weight-only, no KV term."""
        if not pairs:
            return 0
        moves = {(l, e) for (l, e, _s, _d) in pairs}
        D = self.cfg.d_model
        F = self.cfg.d_ff or 4 * D
        per = 3 * D * F * torch_dtype(self.cfg.param_dtype).itemsize
        return int(len(moves) * per)

    def _log_interval(self, plan, applied: bool, reason: Optional[str] = None,
                      expert_applied: bool = False,
                      expert_reason: Optional[str] = None):
        epairs = plan.get("expert_migrations") or []
        self.migration_log.append({
            "step": self.decode_steps,
            "arrival_rate": plan["arrival_rate"],
            "queue_depth": plan["queue_depth"],
            "n_migrations": len(plan["migrations"]),
            "mig_bytes": self._migration_bytes(plan["migrations"]),
            "n_expert_migrations": len(epairs),
            "expert_mig_bytes": self._expert_migration_bytes(epairs),
            "d_mig_est": plan["d_mig_est"],
            "d_pipe_est": plan["d_pipe_est"],
            "applied": applied, "reason": reason,
            "expert_applied": expert_applied,
            "expert_reason": expert_reason})


class ServingEngine(_EngineBase):
    """Continuous-batching scheduler: persistent per-slot KV cache, admit-
    on-free-slot, bucketed prefill, per-slot decode masking, and Algorithm
    1's placements applied as live head (and expert) migrations.  A
    sliding-window arch is served here only below its window, where its
    cache stays linear (``supports_continuous``).

    ``pipeline_k`` > 1 keeps K decode tokens in flight across slot groups:
    the slots split into K contiguous groups of ``rows_per_group`` with a
    decode state each (``states``; paged: an allocator and pool each,
    ``allocators``), and each scheduler step decodes ONE group, the one
    whose phase ``decode_steps % K`` is due.  An empty due group is a
    pipeline bubble: the step count advances, and nothing is launched.  A
    slot emits one token every K steps, so the controller fires every λ·K
    steps (λ tokens a slot).  ``state`` and ``allocator`` name the one
    group of a ``pipeline_k=1`` engine.

    Paged on a mesh (``part``) whose batch axes ("pod" x "data") hold
    ``batch_ranks`` ranks, each group's rows and its ``kv_pages`` split
    evenly over them (else the engine raises): ``allocators`` holds one
    allocator a (group, batch rank), group-major, each over its rank's
    ``rows_per_rank`` rows and ``kv_pages / batch_ranks`` pages with
    rank-local ids, and the decode state holds each rank's pool on that
    rank.  Admission keeps the reference's rule: the lowest free slot
    takes the queue head from its own rank's allocator, and waits when
    that pool cannot reserve (``rank_page_waits`` counts it by rank).
    The default pool, the dense reservation, never waits; a smaller one
    may wait where the reference's one pool would not."""

    def __init__(self, cfg: ModelConfig, *, paged: bool = False,
                 page_size: int = 64, kv_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None, img_tokens: int = 16,
                 **kw):
        # config-only check before params and controller are built; the
        # served extent decides whether a sliding-window arch stays linear
        reason = supports_continuous(cfg, kw.get("max_seq", 512))
        if reason is not None:
            raise UnsupportedArchError(reason + "; use WaveServingEngine")
        if paged and cfg.family == "vlm":
            raise UnsupportedArchError(
                "paged KV does not yet carry the VLM image K/V; "
                "use paged=False")
        part = kw.get("part")
        # a paged pool splits over the mesh's batch ranks ("pod" x "data"):
        # one allocator and pool for each (slot group, batch rank)
        self.batch_ranks = dp_degree(part.mesh) \
            if part is not None and part.mesh is not None else 1
        if paged:
            rows = kw.get("n_slots", 4) // max(1, kw.get("pipeline_k", 1))
            pages = kv_pages if kv_pages is not None \
                else rows * (kw.get("max_seq", 512) // page_size)
            if rows % self.batch_ranks or pages % self.batch_ranks:
                raise ValueError(
                    f"a paged engine on a mesh of {self.batch_ranks} batch "
                    f"ranks splits each slot group's {rows} rows and "
                    f"kv_pages={pages} pages over them: both must divide "
                    f"evenly")
        # a paged engine prices cache memory (and so migration bytes) at
        # page granularity — what the allocator actually hands out
        super().__init__(cfg, cost_page_size=page_size if paged else 0, **kw)
        hd = self.model.hd
        if self.n_slots % self.pipeline_k:
            raise ValueError(f"n_slots={self.n_slots} must be divisible by "
                             f"pipeline_k={self.pipeline_k}")
        if self.pipeline_k > 1 and not self.greedy:
            raise ValueError("pipeline_k > 1 requires greedy decoding "
                             "(host-side sampling would serialize groups)")
        self.rows_per_group = self.n_slots // self.pipeline_k
        self.buckets = default_buckets(self.max_seq)
        # a VLM slot holds a fixed buffer of ``img_tokens`` image rows
        self.is_vlm = cfg.family == "vlm"
        self.img_tokens = img_tokens
        self.paged = bool(paged)
        if self.paged:
            if self.max_seq % page_size:
                raise ValueError(f"max_seq={self.max_seq} must be a "
                                 f"multiple of page_size={page_size}")
            self.page_size = int(page_size)
            self.pages_per_slot = self.max_seq // self.page_size
            # pool size per decode group: default = the group's full dense
            # reservation (paged is then a pure re-layout); a SMALLER pool
            # is the memory-budget knob — the same bytes admit more slots,
            # which hold only live pages
            self.kv_pages = int(kv_pages) if kv_pages is not None \
                else self.rows_per_group * self.pages_per_slot
            # one allocator a (group, batch rank), group-major: batch rank
            # b of group g holds rows [b, b + 1) x rows_per_rank of the
            # group and a pool of kv_pages / batch_ranks pages, with
            # rank-local ids.  Every rank keeps every allocator: the
            # bookkeeping, and so the schedule, is the same on all ranks
            self.rows_per_rank = self.rows_per_group // self.batch_ranks
            self.allocators = [self._new_allocator()
                               for _ in range(self.pipeline_k
                                              * self.batch_ranks)]
            # one fixed chunk shape serves every prompt
            self.prefill_chunk = int(prefill_chunk or self.page_size)
        # scheduler steps at which the queue head waited for pages while a
        # slot was free (head-of-line admission), in all and by the batch
        # rank whose pool was dry
        self.page_waits = 0
        self.rank_page_waits = [0] * self.batch_ranks
        # kernelized decode: per-layer gather maps (physical q-head rows in
        # slot-grouped placement order) carried in the decode state.  A
        # VLM's (G, 4, ...) stacks migrate all layers alike, so the
        # identity rows the model defaults to stay right there.
        self._rows_layers = 0
        if self.use_kernel and not self.is_vlm:
            hps = self.controller.cfg.heads_per_slot
            if self.net.n_devices * hps != hd.Hp:
                raise UnsupportedArchError(
                    f"use_kernel: the bridge's {self.net.n_devices}x"
                    f"{hps} head-position space must equal the "
                    f"model's {hd.Hp} padded heads for placement-derived "
                    f"kernel grids")
            self._rows_layers = self.cfg.n_layers
            self._head_rows, self._head_inv = identity_head_rows(
                self._rows_layers, hd.Hp)
            self._phys_perms = None   # the plan's perms, as the reference
            # the layout the migrations applied: position p of layer l
            # holds head ``_layout[l, p]`` of the init's order
            self._layout = self._head_rows.copy()
            self._local_rows = self._localize(self._head_rows)
        self.states: List[Dict[str, Any]] = [
            self._attach_head_rows(self._fresh_state(self.rows_per_group))
            for _ in range(self.pipeline_k)]
        self.slots: List[Optional[Request]] = [None] * self.n_slots
        self._next = np.zeros(self.n_slots, np.int32)
        self.prefill_buckets_used: set = set()
        self.slot_busy_steps = 0              # sum of active slots per step
        # scheduler decisions, bounded: a serving loop must not grow per
        # request ({step, slot, rid, bucket}, and pages when paged)
        self.admission_log: Deque[dict] = collections.deque(maxlen=4096)
        # elastic churn: recovery events (fail, rejoin) with their replay
        # accounting, and the client-visible tokens recovery dropped
        # (teacher-forced replay re-derives every stream: it stays 0)
        self.recovery_log: List[dict] = []
        self.tokens_lost = 0
        self._replan_pending = False

    def _fresh_state(self, batch: int, max_seq: Optional[int] = None,
                     img: Optional[np.ndarray] = None,
                     img_mask: Optional[np.ndarray] = None):
        """A per-slot decode state of ``batch`` rows.  A VLM's carries the
        image K/V of ``img`` (batch, img_tokens, D) under ``img_mask``
        (batch, img_tokens), in the model's dtype; without them every row
        is an empty, fully masked image (zero K/V: an imageless slot's
        cross-attention adds nothing).  On a mesh the image buffer and its
        mask are placed first, batch rows over the data axes as the state
        places them (a one-row admission's whole there), so each rank
        projects only its rows."""
        if self.paged:
            return self.model.init_paged_state(
                self.params, batch, self.kv_pages, self.page_size,
                self.pages_per_slot)
        kw: Dict[str, Any] = {}
        if self.is_vlm:
            dt, dev = torch_dtype(self.cfg.dtype), self.device
            if img is None:
                kw["img_embeds"] = torch.zeros(
                    (batch, self.img_tokens, self.cfg.d_model), dtype=dt,
                    device=dev)
                kw["img_mask"] = torch.zeros((batch, self.img_tokens),
                                             dtype=torch.bool, device=dev)
            else:
                kw["img_embeds"] = torch.as_tensor(img, device=dev).to(dt)
                kw["img_mask"] = torch.as_tensor(img_mask, device=dev)
            part = self.part.for_batch(batch)
            kw["img_embeds"] = part.shard(kw["img_embeds"],
                                          ("batch", "img_seq", None))
            kw["img_mask"] = part.shard(kw["img_mask"], ("batch", "img_seq"))
        return self.model.init_decode_state(
            self.params, batch, max_seq or self.max_seq, per_slot=True, **kw)

    # ---------------------------------------------------------------- intake
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               img_embeds: Optional[np.ndarray] = None) -> int:
        """``img_embeds`` (I, d_model), I <= ``img_tokens``: a VLM
        request's image patch embeddings, right-padded and masked into the
        slot's fixed image buffer.  Rejected at intake, not mid-run."""
        self._bucket(len(np.asarray(prompt)))   # reject over-long at intake
        if img_embeds is not None and not self.is_vlm:
            raise ValueError(f"{self.cfg.name} is not a VLM: it takes no "
                             f"image embeddings")
        rid = super().submit(prompt, max_new_tokens)
        if self.is_vlm:
            req = self.queue[-1]
            img = np.zeros((self.img_tokens, self.cfg.d_model), np.float32)
            mask = np.zeros((self.img_tokens,), bool)
            if img_embeds is not None:
                img_embeds = np.asarray(img_embeds)
                n = img_embeds.shape[0]
                if img_embeds.ndim != 2 or n > self.img_tokens \
                        or img_embeds.shape[1] != self.cfg.d_model:
                    raise ValueError(
                        f"img_embeds must be (I<={self.img_tokens}, "
                        f"{self.cfg.d_model}), got {img_embeds.shape}")
                img[:n] = img_embeds
                mask[:n] = True
            req.img, req.img_mask = img, mask
        return rid

    # ------------------------------------------------------------- geometry
    @property
    def state(self) -> Dict[str, Any]:
        """The decode state of a single-group engine (a pipelined engine
        holds one per in-flight group in ``states``)."""
        assert self.pipeline_k == 1, "pipelined engine: use .states[g]"
        return self.states[0]

    @property
    def allocator(self) -> PagedKVAllocator:
        """The page allocator of a single-group paged engine on one batch
        rank (otherwise ``allocators`` holds one per group and batch
        rank)."""
        assert len(self.allocators) == 1, \
            "pipelined or multi-rank engine: use .allocators"
        return self.allocators[0]

    def _group_of(self, slot: int) -> tuple:
        return slot // self.rows_per_group, slot % self.rows_per_group

    def _new_allocator(self) -> PagedKVAllocator:
        """A fresh allocator of one (group, batch rank)'s pool."""
        return PagedKVAllocator(self.kv_pages // self.batch_ranks,
                                self.page_size, self.rows_per_rank,
                                self.pages_per_slot)

    def _pool(self, g: int, row: int) -> tuple:
        """(allocator, its row) of group ``g``'s row ``row``: the
        allocator of the batch rank holding the row."""
        b, pool_row = divmod(row, self.rows_per_rank)
        return self.allocators[g * self.batch_ranks + b], pool_row

    def _live_cache_tokens(self) -> int:
        """KV tokens a migration moves, summed over slots: a dense engine
        holds (and must copy) the full reserved ``n_slots × max_seq``
        extent per kv row, a paged engine only its allocated pages, summed
        over groups."""
        if self.paged:
            return sum(a.live_pages for a in self.allocators) \
                * self.page_size
        return super()._live_cache_tokens()

    def _apply_plan(self, plan: dict):
        """Execute a controller plan on every in-flight group: cache
        permutations (the shared weights once), expert weight rows once,
        kernel gather maps, interval log."""
        applied, reason = False, None
        if plan["migrations"]:
            for g, st in enumerate(self.states):
                applied, reason = self._migrate_state(
                    st, plan, permute_params=(g == 0))
        if applied:
            # weights/caches now sit in the plan's layout; the kernel
            # gather maps must follow the same source of truth
            self._phys_perms = plan["perms"]
            if self._rows_layers:
                rel = relative_perms(plan["prev_perms"], plan["perms"])
                self._layout = np.take_along_axis(
                    self._layout, np.broadcast_to(rel, self._layout.shape),
                    axis=1)
        e_applied, e_reason = self._migrate_experts(plan)
        self._refresh_head_rows(plan)
        self._log_interval(plan, applied, reason, e_applied, e_reason)

    # ----------------------------------------------------- kernel row maps
    def _attach_head_rows(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The current kernel row maps into ``state``: on a mesh this
        rank's own (``_localize``)."""
        if not self._rows_layers:
            return state
        rows, inv = (self._head_rows, self._head_inv) \
            if self.part.mesh is None else self._local_rows
        state["head_rows"] = torch.as_tensor(rows, device=self.device)
        state["head_inv"] = torch.as_tensor(inv, device=self.device)
        return state

    def _localize(self, rows: np.ndarray) -> tuple:
        """Row maps (L, Hp) of physical q-head rows cut to the heads this
        rank holds (``partitioning.local_head_rows``); None without a
        mesh."""
        if self.part.mesh is None:
            return None
        Hp = self.model.hd.Hp
        lo, n = local_extent((Hp,), Sharding(self.part.mesh, placements(
            self.part.mesh, ("model",))))[0]
        return local_head_rows(rows, lo, n)

    def _refresh_head_rows(self, plan: dict):
        """Rebuild the kernel gather maps from the controller's plan: the
        resident slices of the BlockGraph placement, mapped through the
        physical layout actually applied to weights and caches.  After a
        migration the maps MUST be rebuilt or the kernel would read stale
        rows.  The whole maps name the plan's perms, as the reference's do;
        a rank of a mesh takes its own rows from the layout the migrations
        applied (``_layout``): the heads it holds are that layout's
        chunk."""
        if not self._rows_layers:
            return
        blocks, n_dev, Hp = (self.controller.blocks, self.net.n_devices,
                             self.model.hd.Hp)
        rows, inv = head_row_maps(plan["place"], blocks, n_dev, Hp,
                                  perms=self._phys_perms)
        # a columns-mode controller's one row serves every model layer
        shape = (self._rows_layers, rows.shape[1])
        self._head_rows = np.broadcast_to(rows, shape).copy()
        self._head_inv = np.broadcast_to(inv, shape).copy()
        if self.part.mesh is not None:
            applied, _ = head_row_maps(plan["place"], blocks, n_dev, Hp,
                                       perms=self._layout)
            self._local_rows = self._localize(
                np.broadcast_to(applied, shape))
        for st in self.states:
            self._attach_head_rows(st)

    # ------------------------------------------------------------- scheduler
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket "
                         f"{self.buckets[-1]}")

    def _retire(self, slot: int):
        r = self.slots[slot]
        r.done = True
        r.t_done = time.monotonic()
        self.finished.append(r)
        self.slots[slot] = None
        self._next[slot] = 0
        if self.paged:
            # free the slot's pages and unmount its table row: the row's
            # future (clamped) writes drop and its reads are masked, so
            # recycled pages cannot be corrupted by a retired slot
            g, row = self._group_of(slot)
            alloc, pool_row = self._pool(g, row)
            alloc.release(pool_row)
            self._mount(g, row, 0)
        self._emit_done(r)

    def _finish_check(self, slot: int):
        r = self.slots[slot]
        if (len(r.out_tokens) >= r.max_new_tokens
                or len(r.prompt) + len(r.out_tokens) >= self.max_seq - 1):
            self._retire(slot)

    def _admit(self):
        """Fill every free slot from the queue (FIFO, any prompt length)."""
        while self.queue:
            s = next((i for i in range(self.n_slots)
                      if self.slots[i] is None), None)
            if s is None:
                return
            if self.paged:
                if not self._admit_paged(s):
                    self.page_waits += 1
                    self.rank_page_waits[
                        self._group_of(s)[1] // self.rows_per_rank] += 1
                    return      # head-of-line: wait for pages to free
                continue
            r = self.queue.pop(0)
            logits, Lb = self._prefill_dense(s, r)
            self.prefill_buckets_used.add(Lb)
            self._start_stream(s, r, logits, {"bucket": Lb})

    def _prefill_dense(self, s: int, r: Request) -> tuple:
        """Prefill ``r``'s prompt right-padded to its bucket at batch 1 and
        copy it into slot ``s``'s row of its group state.  Admission and
        replay both run it: replay is exact only through the very calls
        admission made.  Returns (last prompt token's logits, bucket)."""
        L0 = len(r.prompt)
        Lb = self._bucket(L0)
        toks = np.zeros((1, Lb), np.int32)
        toks[0, :L0] = r.prompt
        sub = self._fresh_state(
            1, Lb, img=None if r.img is None else r.img[None],
            img_mask=None if r.img is None else r.img_mask[None])
        logits, sub = self.model.prefill_bucketed(
            self.params, sub, torch.as_tensor(toks, device=self.device),
            torch.tensor([L0], dtype=torch.int32, device=self.device))
        g, row = self._group_of(s)
        self.states[g] = self.model.insert_slot(self.states[g], sub, row)
        return logits, Lb

    def _start_stream(self, s: int, r: Request, logits, logged: dict):
        """Seat prefilled request ``r`` in slot ``s``, emit its first token
        and log the admission (``logged``: its bucket, and pages)."""
        r.t_first = time.monotonic()
        self.slots[s] = r
        # the admission-time sample is the scheduler's sync point: the
        # first token must reach the host before the slot can decode
        tok = int(self._sample(logits)[0])
        self._next[s] = tok
        self._emit_token(r, tok)
        self.admission_log.append({"step": self.decode_steps, "slot": s,
                                   "rid": r.rid, **logged})
        self._finish_check(s)

    def _mount(self, g: int, row: int, pos: int):
        """Mirror ``row``'s page list (-1 padded; ids of its batch rank's
        pool) and its position into group ``g``'s decode state."""
        alloc, pool_row = self._pool(g, row)
        self.states[g] = self.model.mount_slot_pages(
            self.states[g], row, alloc.page_map_row(pool_row), pos)

    def _admit_paged(self, s: int) -> bool:
        """Admit the queue head into free slot ``s``: reserve its
        worst-case page footprint (prompt + its own decode budget, so
        decode-time extension can never exhaust the pool mid-stream),
        allocate the prompt's pages, mount the table row, and run the
        prompt through fixed-size prefill chunks.  Returns False when the
        slot's pool — its batch rank's — cannot reserve yet (head-of-line
        wait: the request admits once running slots retire)."""
        r = self.queue[0]
        g, row = self._group_of(s)
        if not self._pool(g, row)[0].can_admit(len(r.prompt),
                                               self._horizon(r)):
            return False
        self.queue.pop(0)
        logits, pages = self._prefill_paged(g, row, r)
        self.prefill_buckets_used.add(self.prefill_chunk)
        self._start_stream(s, r, logits, {"bucket": self.prefill_chunk,
                                          "pages": pages})
        return True

    def _horizon(self, r: Request) -> int:
        """Tokens a request may ever hold: its prompt, its decode budget
        and the last token's write, capped at the cache extent."""
        return min(len(r.prompt) + r.max_new_tokens + 1, self.max_seq)

    def _prefill_paged(self, g: int, row: int, r: Request) -> tuple:
        """Reserve ``r``'s worst-case pages in the pool of group ``g``'s
        row, allocate its prompt's, mount the table row and run the prompt
        through fixed-size prefill chunks.  Admission and replay both run
        it.  Returns (last prompt token's logits, pages allocated)."""
        L0 = len(r.prompt)
        alloc, pool_row = self._pool(g, row)
        pages = alloc.admit(pool_row, n_tokens=L0, horizon=self._horizon(r))
        self._mount(g, row, 0)
        C = self.prefill_chunk
        logits = None
        for c0 in range(0, max(L0, 1), C):
            n = min(C, L0 - c0)
            toks = np.zeros((1, C), np.int32)
            toks[0, :n] = r.prompt[c0:c0 + n]
            logits, self.states[g] = self.model.prefill_paged(
                self.params, self.states[g],
                torch.as_tensor(toks, device=self.device), row, c0, n)
        return logits, len(pages)

    def _ensure_pages(self, g: int, active: List[int], lo: int):
        """Lazy page growth: before group ``g`` decodes, any slot whose
        next write position crosses into an unallocated page draws one
        from its admission reservation and remounts its table row — live
        bytes track actual depth, not the reservation."""
        for s in active:
            r = self.slots[s]
            self._extend_pages(g, s - lo,
                               len(r.prompt) + len(r.out_tokens) - 1)

    def _extend_pages(self, g: int, row: int, write_pos: int):
        """Draw a page from ``row``'s reservation when ``write_pos`` falls
        past its allocated pages, and remount the row."""
        alloc, pool_row = self._pool(g, row)
        if write_pos >= alloc.pages_for(pool_row) * self.page_size:
            alloc.extend(pool_row, write_pos + 1)
            self._mount(g, row, write_pos)

    def _active(self) -> List[int]:
        return [s for s in range(self.n_slots) if self.slots[s] is not None]

    def _group_active(self, g: int) -> List[int]:
        lo = g * self.rows_per_group
        return [s for s in range(lo, lo + self.rows_per_group)
                if self.slots[s] is not None]

    def _occupancy(self) -> float:
        """Mean tokens resident per active slot (prompt + generated).
        Paged engines report page-rounded ALLOCATED tokens — the τ anchor
        then prices exactly the memory the allocator handed out."""
        act = self._active()
        if not act:
            return 0.0
        if self.paged:
            return float(np.mean(
                [alloc.pages_for(pool_row) * self.page_size
                 for alloc, pool_row in (self._pool(*self._group_of(s))
                                         for s in act)]))
        return float(np.mean([len(self.slots[s].prompt)
                              + len(self.slots[s].out_tokens) for s in act]))

    def step(self) -> bool:
        """One scheduler iteration: admit into free slots, then one decode
        step for the group whose pipeline phase is due (with
        ``pipeline_k=1`` every active slot), then — every λ·K steps, or on
        the step after ``request_replan`` — the controller interval.
        Returns False when idle.  An empty due group is a bubble: the step
        count advances, nothing is launched or timed."""
        self._admit()
        if not self._active():
            return False
        g = self.decode_steps % self.pipeline_k
        lo = g * self.rows_per_group
        active = self._group_active(g)
        if active:
            if self.paged:
                self._ensure_pages(g, active, lo)
            t0 = time.monotonic()
            nxt = self._next[lo:lo + self.rows_per_group]
            logits, self.states[g] = self.model.decode_step(
                self.params, self.states[g],
                torch.as_tensor(nxt, device=self.device))
            self._sync()
            dt = time.monotonic() - t0
            toks = self._sample(logits)
        self.decode_steps += 1
        if active:
            self.slot_busy_steps += len(active)
            for s in active:
                tok = int(toks[s - lo])
                self._emit_token(self.slots[s], tok)
                self._next[s] = tok
                self._finish_check(s)
            self._record_step(dt)
        # a slot emits one token every pipeline_k steps: λ tokens a slot
        # are λ·K scheduler steps
        if self._replan_pending \
                or self.decode_steps % (self.lam * self.pipeline_k) == 0:
            self._replan_pending = False
            t0 = time.monotonic()
            # live router loads first: this interval's expert placement is
            # priced by the decode stream's gate frequencies, not the prior
            self._feed_expert_loads(self.states)
            plan = self._interval_plan(tau_tokens=self._occupancy())
            self._apply_plan(plan)
            self._sync()
            self.interval_times.append(time.monotonic() - t0)
        return True

    def run(self, max_steps: int = 10_000):
        while self.decode_steps < max_steps:
            if not self.step():
                break
        return self.finished

    # ------------------------------------------------------------- churn
    def request_replan(self):
        """Fire the controller interval on the next scheduler step,
        whatever the λ cadence — the async watchdog's escalation hook (a
        hang must not wait out a long interval)."""
        self._replan_pending = True

    def slow_device(self, device: int, factor: float):
        """Persistent ``factor``x slowdown of ``device``: pinned load the
        next interval observes, where Algorithm 1 migrates away iff the
        move pays."""
        self.net.slow(device, factor)

    def fail_device(self, device: int) -> dict:
        """Device death mid-decode: evacuate, then recover bit for bit.

        The controller's evacuation plan moves the dead device's blocks to
        survivors (raising when they cannot hold them) and ``_apply_plan``
        permutes weights and caches into the new layout.  The dead
        device's cache rows are lost, so every in-flight stream is rebuilt
        by teacher-forced replay of its emitted tokens through the
        engine's own prefill and decode calls (same calls, same batch
        geometry: the same cache, so the same surviving streams).  No
        client-visible token is dropped and replay re-emits nothing."""
        if not self.net.is_active(device):
            raise ValueError(f"device {device} is not active")
        self.monitor.mark_failed(device)
        self._feed_expert_loads(self.states)
        plan = self.controller.handle_failure(
            device, tau=self._tau_of(self._occupancy()))
        self._apply_plan(plan)
        stats = self._replay_groups()
        self.recovery_log.append({
            "step": self.decode_steps, "event": "fail",
            "device": int(device), "tokens_lost": 0,
            "d_mig_est": plan["d_mig_est"],
            "d_pipe_est": plan["d_pipe_est"], **stats})
        return plan

    def rejoin_device(self, device: int) -> dict:
        """A failed device returns, empty: the controller's expansion plan
        moves blocks onto it where that pays, and ``_apply_plan`` copies
        their KV rows from the survivors, so rejoin needs no replay."""
        if self.net.is_active(device):
            raise ValueError(f"device {device} is already active")
        plan = self.controller.handle_rejoin(
            device, tau=self._tau_of(self._occupancy()))
        self.monitor.record_heartbeat(device)
        self._apply_plan(plan)
        self.recovery_log.append({
            "step": self.decode_steps, "event": "rejoin",
            "device": int(device),
            "n_migrations": len(plan["migrations"])})
        return plan

    # ----------------------------------------------------------- replay
    def _replay_groups(self) -> dict:
        stats = {"replay_steps": 0, "replay_prefills": 0,
                 "replayed_slots": 0}
        for g in range(self.pipeline_k):
            for k, v in self._replay_group(g).items():
                stats[k] += v
        return stats

    def _replay_group(self, g: int) -> dict:
        """Rebuild group ``g``'s KV cache from its slots' request records.

        Slots are prefilled again, then teacher-forced through the same
        decode call in the same batch geometry, each emitted token fed at
        the position that produced its successor.  Unequal depths are
        staggered: with n_s tokens emitted on slot s and N = max(n_s),
        slot s is inserted at tick N - n_s so every slot ends together;
        before its insertion a row decodes garbage as a freed row does,
        which cannot touch other rows.  The rebuilt state takes the
        current kernel row maps (the plan just changed the layout).
        Replay samples and emits nothing: ``_next``, ``decode_steps`` and
        ``step_times`` stay as live decode left them."""
        active = self._group_active(g)
        lo = g * self.rows_per_group
        if self.paged:
            # the old pools described the lost cache; fresh ones admitted
            # again reproduce admission's reservations
            for b in range(self.batch_ranks):
                self.allocators[g * self.batch_ranks + b] = \
                    self._new_allocator()
        self.states[g] = self._attach_head_rows(
            self._fresh_state(self.rows_per_group))
        out = {"replay_steps": 0, "replay_prefills": 0,
               "replayed_slots": len(active)}
        if not active:
            return out
        ns = {s: len(self.slots[s].out_tokens) for s in active}
        max_n = max(ns.values())
        for i in range(max_n):
            for s in active:
                if max_n - ns[s] == i:
                    self._replay_insert(g, s)
                    out["replay_prefills"] += 1
            if i == max_n - 1:
                break   # the last emitted token was never decoded upon
            nxt = np.zeros(self.rows_per_group, np.int32)
            for s in active:
                k = i - (max_n - ns[s])
                if k >= 0:
                    r = self.slots[s]
                    nxt[s - lo] = r.out_tokens[k]
                    if self.paged:
                        # this step writes position L0 + k of slot s
                        self._extend_pages(g, s - lo, len(r.prompt) + k)
            _, self.states[g] = self.model.decode_step(
                self.params, self.states[g],
                torch.as_tensor(nxt, device=self.device))
            out["replay_steps"] += 1
        return out

    def _replay_insert(self, g: int, s: int):
        """Run slot ``s``'s admission prefill again (the same calls, the
        same bucket or chunks, a VLM request's image) into the rebuilt
        group state."""
        r = self.slots[s]
        if self.paged:
            self._prefill_paged(g, s - g * self.rows_per_group, r)
        else:
            self._prefill_dense(s, r)


class WaveServingEngine(_EngineBase):
    """The static wave scheduler: up to ``n_slots`` equal-length prompts
    form a wave, prefill as one batch and decode in lock-step (one int
    position for the batch) until every request of the wave finishes;
    slots free only when the wave drains.  It serves sliding-window archs
    over their ring cache, the attention-free RWKV-6 and the Zamba2
    hybrid (whose head plans are logged as not applied), and any other
    arch the port builds; with ``part`` (any family) its states are
    placed on the mesh and prefill and lock-step
    decode run sharded, a ring's slot positions replicated on every rank;
    the recurrent families' plans apply nothing there either, so no rank
    sends a row."""

    def _next_wave(self) -> List[Request]:
        """Up to n_slots queued requests with equal prompt length."""
        if not self.queue:
            return []
        L0 = len(self.queue[0].prompt)
        wave = [r for r in self.queue if len(r.prompt) == L0][:self.n_slots]
        for r in wave:
            self.queue.remove(r)
        return wave

    def _interval(self, state: Dict[str, Any]):
        """The paper's controller interval: observe -> Algorithm 1 ->
        migrate head shards (weights and ``state``'s cache) and expert
        weight rows in the decode gap.  The controller advances its own τ
        (the reference's wave scheduler passes no occupancy)."""
        t0 = time.monotonic()
        self._feed_expert_loads([state])
        plan = self._interval_plan()
        applied, reason = False, None
        if plan["migrations"]:
            applied, reason = self._migrate_state(state, plan)
        e_applied, e_reason = self._migrate_experts(plan)
        self._log_interval(plan, applied, reason, e_applied, e_reason)
        self._sync()
        self.interval_times.append(time.monotonic() - t0)

    def _run_wave(self, wave: List[Request], max_steps: int):
        B = self.n_slots
        L0 = len(wave[0].prompt)
        prompts = np.zeros((B, L0), np.int32)
        for i, r in enumerate(wave):
            prompts[i] = r.prompt
        state = self.model.init_decode_state(self.params, B, self.max_seq)
        logits, state = self.model.prefill(
            self.params, state, torch.as_tensor(prompts, device=self.device))
        for r in wave:
            r.t_first = time.monotonic()
        active = {i: r for i, r in enumerate(wave)}
        nxt = self._sample(logits)
        while active and self.decode_steps < max_steps:
            for i, r in list(active.items()):
                self._emit_token(r, int(nxt[i]))
                if (len(r.out_tokens) >= r.max_new_tokens
                        or L0 + len(r.out_tokens) >= self.max_seq - 1):
                    r.done = True
                    r.t_done = time.monotonic()
                    self.finished.append(r)
                    del active[i]
                    self._emit_done(r)
            if not active:
                break
            t0 = time.monotonic()
            logits, state = self.model.decode_step(
                self.params, state, torch.as_tensor(nxt, device=self.device))
            self._sync()
            dt = time.monotonic() - t0
            nxt = self._sample(logits)
            self.decode_steps += 1
            self._record_step(dt)
            if self.decode_steps % self.lam == 0:
                self._interval(state)

    def run(self, max_steps: int = 10_000):
        while self.queue and self.decode_steps < max_steps:
            wave = self._next_wave()
            if not wave:
                break
            self._run_wave(wave, max_steps)
        return self.finished


def make_engine(cfg: ModelConfig, *, mode: str = "auto", **kw):
    """``continuous`` | ``wave`` | ``auto`` (continuous when the arch and
    the served extent support the slot API, wave otherwise: the
    continuous engine refuses at construction, before building params)."""
    if mode == "wave":
        return WaveServingEngine(cfg, **kw)
    if mode == "continuous":
        return ServingEngine(cfg, **kw)
    if mode != "auto":
        raise ValueError(f"mode must be auto, continuous or wave; got "
                         f"{mode!r}")
    try:
        return ServingEngine(cfg, **kw)
    except NotImplementedError:
        return WaveServingEngine(cfg, **kw)
