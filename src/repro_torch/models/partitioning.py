"""Logical-axis partitioning — counterpart of the JAX package's
``models/partitioning.py`` on a ``torch.distributed`` ``DeviceMesh``.

Models annotate intermediates with *logical* axis names; a
:class:`Partitioner` maps them to mesh dimensions.  ``spec`` returns the
reference's ``PartitionSpec`` entries as a tuple (one entry per tensor
dimension: ``None``, a mesh dimension's name, or a tuple of names);
``placements`` turns such a spec into one ``Shard(d)``/``Replicate()`` per
mesh dimension, the DTensor form of a ``NamedSharding``; ``constrain``
redistributes a DTensor to the spec's placements (the reference's
``with_sharding_constraint``) and leaves a plain tensor as it is.  The
default :class:`NullPartitioner` does nothing, so every model runs
unsharded on one device.

Mesh dimensions are named "data" and "model", with "pod" in front where
present.  Logical axes used across the models::

  batch seq res_seq heads kv_heads head_dim d_model d_ff vocab experts
  ssm_heads ssm_state cache_seq img_seq fsdp
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MeshAxis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxis, ...]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: the ``DeviceMesh`` and one
    placement per mesh dimension (the reference's ``NamedSharding``).  A
    leaf of the trees ``tree`` walks, as a ``NamedSharding`` is."""
    mesh: object
    placements: tuple


def mesh_device_type(device_type=None) -> str:
    """A mesh's device type: ``None`` means "cuda", and raises where no
    GPU is present; "cpu" builds a gloo mesh."""
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass "
                               "device_type='cpu' for a CPU mesh")
        return "cuda"
    return device_type


def _size(mesh, name: str) -> int:
    return mesh.size(tuple(mesh.mesh_dim_names).index(name))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh dimensions a batch's rows lie over, outermost first:
    ("pod", "data") where the mesh has "pod", else ("data",) — the decode
    state's batch axes, a paged store's page axis among them."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def tp_degree(mesh) -> int:
    """The mesh's "model" dimension: the head-level TP degree."""
    return _size(mesh, "model")


def dp_degree(mesh) -> int:
    """The data-parallel degree: "data" times "pod" where present."""
    d = _size(mesh, "data")
    if "pod" in mesh.mesh_dim_names:
        d *= _size(mesh, "pod")
    return d


def placements(mesh, spec: Sequence[MeshAxis]) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` per dimension of ``mesh``:
    mesh dimension m shards tensor dimension d where ``spec[d]`` names it
    (a tuple entry shards d over several mesh dimensions, the first
    outermost, as the reference's).  Naming a dimension the mesh lacks
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name not in names:
                raise ValueError(f"spec {tuple(spec)} names mesh dimension "
                                 f"{name!r}; the mesh has {names}")
            out[names.index(name)] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on: its current CUDA device on
    a "cuda" mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_extent(shape, sharding: Sharding) -> list:
    """This rank's slice of a tensor of ``shape`` placed by ``sharding``:
    one (start, length) per tensor dimension, cut as DTensor cuts a
    ``Shard`` (``torch.chunk``, mesh dimensions in order; a rank past the
    last chunk holds none)."""
    from torch.distributed.tensor import Shard
    mesh, pls = sharding.mesh, sharding.placements
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    ext = [[0, n] for n in shape]
    for m, pl in enumerate(pls):
        if not isinstance(pl, Shard):
            continue
        start, n = ext[pl.dim]
        chunk = -(-n // mesh.size(m)) if n else 0
        lo = min(coord[m] * chunk, n)
        ext[pl.dim] = [start + lo, min(chunk, n - lo)]
    return [tuple(e) for e in ext]


def from_local(local: torch.Tensor, sharding: Sharding, shape):
    """``local`` — this rank's slice of a tensor of ``shape`` placed by
    ``sharding`` — as that DTensor (no collective, no check)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def place(x: torch.Tensor, sharding: Sharding):
    """``x`` — the whole tensor, the same on every rank (a batch drawn from
    a seed, a leaf read from a checkpoint) — as a DTensor placed by
    ``sharding``: each rank keeps its own slice (``local_extent``), so
    placing needs no collective."""
    x = x.contiguous()
    local = x
    for d, (start, n) in enumerate(local_extent(x.shape, sharding)):
        local = local.narrow(d, start, n)
    return from_local(local.to(mesh_device(sharding.mesh)).contiguous(),
                       sharding, x.shape)


def placed_full(shape, fill, dtype, sharding: Sharding):
    """A DTensor of ``shape`` filled with ``fill``, placed by ``sharding``
    and built shard by shard: each rank allocates only its own slice, so
    no rank ever holds the whole tensor (a KV cache)."""
    local = torch.full([n for _, n in local_extent(shape, sharding)], fill,
                       dtype=dtype, device=mesh_device(sharding.mesh))
    return from_local(local, sharding, tuple(shape))


def row_owner(x, row: int) -> tuple:
    """The batch rank holding row ``row`` of DTensor ``x``'s dimension 0:
    ((mesh dimension name, coordinate), ...), innermost first, one for
    each mesh dimension of more than one rank that splits dimension 0 (cut
    as ``local_extent`` cuts it).  Empty for a plain tensor or a dimension
    no mesh dimension splits."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x):
        return ()
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    start, n, out = 0, x.shape[0], []
    for m, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == 0 and mesh.size(m) > 1:
            chunk = -(-n // mesh.size(m))
            c = (row - start) // chunk
            out.append((names[m], c))
            start, n = start + c * chunk, min(chunk, n - c * chunk)
    return tuple(reversed(out))


def local_range(x, dim: int) -> Tuple[int, int]:
    """(start, length) of this rank's shard of ``x`` along ``dim``: a
    DTensor's slice (``local_extent``), the whole axis of any other
    tensor."""
    if not is_dtensor(x):
        return 0, x.shape[dim]
    return local_extent(x.shape, Sharding(x.device_mesh,
                                          tuple(x.placements)))[dim]


def local_head_rows(rows, lo: int, n: int):
    """Kernel gather maps localized to the head range ``[lo, lo + n)`` a
    rank holds: ``rows`` (..., H) lists physical q-head rows (each row of
    it a permutation of ``arange(H)``); returns (local rows, their scatter
    map), both (..., n) int32 — the rows that fall in the range, in their
    order, less ``lo``, and ``argsort`` of them.  Run through the kernel on
    the rank's shard, they give that shard of the whole call's output."""
    rows = np.asarray(rows)
    keep = (rows >= lo) & (rows < lo + n)
    if not np.all(keep.sum(-1) == n):
        raise ValueError(f"row maps do not cover the head range "
                         f"[{lo}, {lo + n}) once each")
    local = (rows[keep].reshape(rows.shape[:-1] + (n,)) - lo
             ).astype(np.int32)
    return local, np.argsort(local, axis=-1).astype(np.int32)


class Partitioner:
    """Maps logical axis names to mesh dimensions and constrains
    intermediates."""

    def __init__(self, mesh, rules: Dict[str, MeshAxis], owner=()):
        self.mesh = mesh
        self.rules = dict(rules)
        # ((mesh dimension, coordinate), ...), innermost first: the batch
        # rank whose page pool holds the call's one row (``owned_by``)
        self.owner = tuple(owner)

    # -- specs ---------------------------------------------------------------
    def spec(self, axes: Sequence[Optional[str]]) -> Spec:
        used: set = set()
        parts = []
        for ax in axes:
            m = self.rules.get(ax) if ax is not None else None
            # a mesh axis may appear at most once in a spec; later wins -> None
            if m is None:
                parts.append(None)
                continue
            key = tuple(m) if isinstance(m, tuple) else (m,)
            if used & set(key):
                parts.append(None)
                continue
            used |= set(key)
            # a one-name tuple is that name, as ``PartitionSpec`` keeps it
            parts.append(key[0] if len(key) == 1 else m)
        return tuple(parts)

    def placements(self, axes: Sequence[Optional[str]]) -> tuple:
        if self.mesh is None:
            raise ValueError("a partitioner without a mesh has no "
                             "placements")
        return placements(self.mesh, self.spec(axes))

    def sharding(self, axes: Sequence[Optional[str]]) -> Sharding:
        return Sharding(self.mesh, self.placements(axes))

    def shard(self, x, axes: Sequence[Optional[str]]):
        """A plain tensor, the same on every rank, placed on the mesh as
        ``axes`` say (``place``); a DTensor, or any tensor without a
        mesh, comes back unchanged."""
        if self.mesh is None or is_dtensor(x):
            return x
        return place(x, self.sharding(axes))

    def for_batch(self, batch: int) -> "Partitioner":
        """This partitioner for a batch of ``batch`` rows: itself when the
        rows split evenly over the data axes, else one that keeps the batch
        whole there (a one-row admission prefill on a mesh whose "data" is
        2: each data rank computes the row, and the one holding its slot
        keeps it).  One row always stays whole: DTensor refuses to reshape
        a sharded dimension even of size 1, as ``einsum`` does."""
        if self.mesh is None or (batch > 1
                                 and batch % dp_degree(self.mesh) == 0):
            return self
        return Partitioner(self.mesh, dict(self.rules, batch=None))

    def owned_by(self, owner) -> "Partitioner":
        """This partitioner for a call whose one row lives in one batch
        rank's page pool (a paged prefill chunk on a mesh whose batch axes
        hold several ranks): ``owner`` (``row_owner``) names that rank,
        and ``from_owner`` hands the values it computes to every rank."""
        return Partitioner(self.mesh, self.rules, owner)

    def from_owner(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` — a local tensor — as the ``owner`` rank computed it, on
        every rank: a broadcast over each batch axis's group, innermost
        first (after the first, every rank of the owner's outer coordinate
        holds it).  ``t`` itself where no owner is named."""
        if not self.owner:
            return t
        import torch.distributed as dist
        t = t.contiguous()
        for name, coord in self.owner:
            group = mesh_group(self.mesh, name)
            if group is not None:
                dist.broadcast(t, src=dist.get_global_rank(group, coord),
                               group=group)
        return t

    def region(self):
        """The context a sharded computation runs in: plain tensors that
        meet DTensors (positions, RoPE tables, masks) count as replicated
        on the mesh.  No-op without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()

    # -- constraint ----------------------------------------------------------
    def constrain(self, x, axes: Sequence[Optional[str]]):
        """``x`` redistributed to ``axes``' placements when it is a DTensor
        on this partitioner's mesh; a plain tensor, or any tensor without
        a mesh, comes back unchanged."""
        if self.mesh is None or not is_dtensor(x):
            return x
        want = self.placements(axes)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    def lays_out(self, x, axes: Sequence[Optional[str]]) -> bool:
        """Whether ``x`` already sits as ``axes`` place it: the check that
        stands for ``constrain`` where a tensor is updated in place (a KV
        cache) and a redistributed copy would take the writes.  A plain
        tensor or no mesh: True.  A ``Shard`` over a mesh dimension of size
        1 lays the bytes out as ``Replicate`` does."""
        if self.mesh is None or not is_dtensor(x):
            return True
        return all(have == w or (self.mesh.size(m) == 1
                                 and not have.is_partial()
                                 and not w.is_partial())
                   for m, (have, w) in enumerate(
                       zip(x.placements, self.placements(axes))))


def local_shards(buffers: dict, part, axes: dict) -> dict:
    """The rank's shards of DTensor buffers updated in place (a KV cache,
    a recurrent state), each held to the layout ``axes[name]`` gives it
    at the reference's ``part.constrain`` points: a redistributed copy
    would take the writes, so a buffer laid out otherwise raises
    (``Partitioner.lays_out``).  Plain tensors come back as they are."""
    for name, t in buffers.items():
        if not part.lays_out(t, axes[name]):
            raise ValueError(f"the {name!r} buffer is laid out "
                             f"{tuple(t.placements)}, not as the decode "
                             f"state's rules place it")
    return {name: local(t) for name, t in buffers.items()}


class NullPartitioner(Partitioner):
    def __init__(self):
        super().__init__(None, {})

    def constrain(self, x, axes):  # noqa: D401 - no-op
        return x

    def spec(self, axes):
        return ()


NULL = NullPartitioner()


# ---------------------------------------------------------------------------
# Axis-rule presets.  ``fsdp`` = storage sharding of params over the data
# axis (gathered on use).
# ---------------------------------------------------------------------------

def rules_tp(data_axes: MeshAxis = ("data",), model_axis: str = "model",
             fsdp: bool = False, seq_over_data: bool = False,
             sp: bool = False) -> Dict[str, MeshAxis]:
    """Head-level TP (the paper's axis) + DP over batch.

    seq_over_data: shard the KV-cache sequence dim over the data axis
    (batch 1 cannot use data parallelism).
    sp: sequence parallelism — the residual stream ("res_seq") shards its
    sequence dim over the model axis between blocks.
    """
    last_data = data_axes if isinstance(data_axes, str) else data_axes[-1]
    return {
        "batch": data_axes if not seq_over_data else None,
        "seq": None,
        "res_seq": model_axis if sp else None,
        "heads": model_axis,
        "kv_heads": model_axis,
        "head_dim": None,
        "d_model": None,
        "d_ff": model_axis,
        "vocab": model_axis,
        "experts": None,
        "ssm_heads": model_axis,
        "ssm_state": None,
        "cache_seq": last_data if seq_over_data else None,
        "img_seq": None,
        # param-storage-only axes
        "fsdp": last_data if fsdp else None,
    }


def rules_zero3(data_axes: MeshAxis) -> Dict[str, MeshAxis]:
    """Pure ZeRO-3 / FSDP layout: every mesh axis carries data
    parallelism, no tensor parallelism."""
    return {
        "batch": data_axes, "seq": None, "res_seq": None,
        "heads": None, "kv_heads": None, "head_dim": None,
        "d_model": None, "d_ff": None, "vocab": None, "experts": None,
        "ssm_heads": None, "ssm_state": None, "cache_seq": None,
        "img_seq": None, "fsdp": data_axes,
    }


def make_partitioner(mesh, *, fsdp: bool = False,
                     seq_over_data: bool = False, sp: bool = False,
                     layout: str = "tp") -> Partitioner:
    if mesh is None:
        return NullPartitioner()
    names = tuple(mesh.mesh_dim_names)
    if layout == "zero3":
        return Partitioner(mesh, rules_zero3(names))
    return Partitioner(mesh, rules_tp(data_axes=batch_axes(mesh), fsdp=fsdp,
                                      seq_over_data=seq_over_data, sp=sp))


def local(x):
    """The rank's shard of a DTensor, or ``x`` itself (for ops without a
    DTensor rule: a custom kernel)."""
    return x.to_local() if is_dtensor(x) else x


def whole(x):
    """The whole tensor of a DTensor on every rank (an all-gather); any
    other tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def like(out: torch.Tensor, ref):
    """``out`` — this rank's shard of a result laid out as ``ref`` — as a
    DTensor with ``ref``'s mesh and placements when ``ref`` is one."""
    if not is_dtensor(ref):
        return out
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out, ref.device_mesh, ref.placements,
                              run_check=False)


# ---------------------------------------------------------------------------
# Expert parallelism: a MoE layer on local tensors with explicit collectives
# ---------------------------------------------------------------------------

def mesh_group(mesh, name: str):
    """The process group of mesh dimension ``name``; None where the mesh
    has no such dimension or it holds one rank (nothing to exchange)."""
    names = tuple(mesh.mesh_dim_names)
    if name not in names or _size(mesh, name) == 1:
        return None
    return mesh.get_group(names.index(name))


def _shards(x, name: str, dim: int) -> bool:
    """Whether DTensor ``x`` shards its dimension ``dim`` over mesh
    dimension ``name``."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x):
        return False
    names = tuple(x.device_mesh.mesh_dim_names)
    if name not in names:
        return False
    pl = x.placements[names.index(name)]
    return isinstance(pl, Shard) and pl.dim == dim % x.ndim


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank of ``group``'s ``t``, stacked along dimension 0 in rank
    order (an all-gather); ``t`` itself without a group."""
    if group is None:
        return t
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def scatter_rows_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``t``, each rank keeping its
    chunk of dimension 0 in rank order (a reduce-scatter: the way back of
    ``gather_rows`` for partial sums); ``t`` itself without a group."""
    if group is None:
        return t
    import torch.distributed as dist
    parts = [c.contiguous()
             for c in t.chunk(dist.get_world_size(group))]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def sum_over(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed over the ranks of each group in turn (an all-reduce
    each, in place; None entries skipped).  Returns ``t``."""
    import torch.distributed as dist
    for g in groups:
        if g is not None:
            dist.all_reduce(t, group=g)
    return t


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """How one MoE layer's work splits over a mesh (``expert_shard``).
    This rank computes the physical expert rows ``[lo, lo + n)`` with its
    d_ff slice; ``gather`` ("pod") is the group whose ranks hold other
    expert rows and other tokens: the rank runs its rows on the tokens of
    every rank there, and the partial outputs come back by a
    reduce-scatter.  ``experts`` is the group holding the other expert
    rows (``gather`` too, or, where the batch stays whole on it, a group
    whose partial outputs are all-reduced), ``ff`` ("model") the group
    holding the other d_ff slices, and ``tokens`` the groups of the data
    axes whose ranks hold other tokens (global means are all-reduced over
    them, ``token_ranks`` ranks in all).  Without a mesh: every row, no
    group."""
    lo: int
    n: int
    gather: Optional[object] = None
    experts: Optional[object] = None
    ff: Optional[object] = None
    tokens: tuple = ()
    token_ranks: int = 1

    def gather_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """(B, ...) rows of this rank's tokens -> the rows of every rank
        of ``gather``, whose tokens this rank's experts also serve."""
        return gather_rows(t, self.gather)

    def sum_partials(self, out: torch.Tensor) -> torch.Tensor:
        """The layer's output on this rank's tokens from its partial one
        (its expert rows and d_ff slice over the gathered tokens): summed
        over the expert ranks — scattered back to each rank's tokens where
        they were gathered — and over the d_ff slices."""
        if self.gather is not None:
            out = scatter_rows_sum(out, self.gather)
        elif self.experts is not None:
            out = sum_over(out, (self.experts,))
        return sum_over(out, (self.ff,))

    def sum_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's tokens -> the sum over every token of
        the call (in place)."""
        return sum_over(t, self.tokens)

    def sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A count over this rank's (token, expert row) pairs -> the count
        over every pair of the call (in place): over the expert rows'
        ranks and the ranks of other tokens, each once."""
        groups = self.tokens
        if self.experts is not None and self.gather is None:
            groups = groups + (self.experts,)
        return sum_over(t, groups)


def expert_shard(x, w) -> ExpertShard:
    """The split of a MoE layer with input ``x`` (B, S, D) and expert
    stack ``w`` (..., Ep, D, F) — its ``w_gate`` — over their mesh: the
    expert rows ``w``'s shard holds (sharded over "pod" by
    ``placement_bridge.param_spec`` where the mesh has one), whether its
    d_ff slice is one of several ("model"), and which data axes shard
    ``x``'s batch rows (``Partitioner.for_batch`` keeps a batch whole
    there: every rank already holds every token, and nothing is
    gathered).  A plain ``x``: every row, no group."""
    if not is_dtensor(x):
        return ExpertShard(0, w.shape[-3])
    mesh = x.device_mesh
    lo, n = local_range(w, w.ndim - 3)
    experts = mesh_group(mesh, "pod") if _shards(w, "pod", -3) else None
    tokens = [name for name in ("pod", "data")
              if _shards(x, name, 0) and mesh_group(mesh, name) is not None]
    return ExpertShard(
        lo, n,
        gather=experts if "pod" in tokens else None, experts=experts,
        ff=mesh_group(mesh, "model") if _shards(w, "model", -1) else None,
        tokens=tuple(mesh_group(mesh, name) for name in tokens),
        token_ranks=int(np.prod([_size(mesh, name) for name in tokens])))


# ---------------------------------------------------------------------------
# Head parallelism of the recurrent families: layers on local tensors
# ---------------------------------------------------------------------------

def gather_cols(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank of ``group``'s chunk of the last dimension — cut from
    ``n`` columns as ``torch.chunk`` cuts them, the way DTensor shards —
    put together in rank order: the whole ``n`` columns on every rank (an
    all-gather; a short last chunk is padded for it and trimmed after).
    ``t`` itself without a group."""
    if group is None:
        return t
    import torch.distributed as dist
    ranks = dist.get_world_size(group)
    pad = -(-n // ranks) - t.shape[-1]
    t = torch.nn.functional.pad(t, (0, pad)) if pad else t.contiguous()
    parts = [torch.empty_like(t) for _ in range(ranks)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=-1)[..., :n]


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """How a recurrent layer (RWKV-6's time and channel mix, a Mamba-2
    block) splits over a mesh (``head_shard``).  This rank holds chunk
    ``rank`` of ``ranks`` of every axis placed over "model" (``span``: cut
    as ``torch.chunk`` cuts it, the way DTensor shards) — its heads
    (``heads``), their channels and the weights' matching rows or columns
    — and the batch rows ``rows`` (start, count) of the call over the
    data axes.  ``model`` is the "model" group: partial outputs are summed
    over it (``reduce``) and column shards gathered (``gather``); ``data``
    the groups of the data axes that split the batch, outermost first.
    Without a mesh: every head and row, no group."""
    rows: Tuple[int, int]
    rank: int = 0
    ranks: int = 1
    model: Optional[object] = None
    data: tuple = ()

    def span(self, n: int) -> Tuple[int, int]:
        """(start, length) of this rank's chunk of an axis of ``n``."""
        chunk = -(-n // self.ranks) if n else 0
        lo = min(self.rank * chunk, n)
        return lo, min(chunk, n - lo)

    def heads(self, n: int) -> Tuple[int, int]:
        """(first, count) of this rank's heads of ``n``; a "model" degree
        that does not divide them raises (a head's channels would fall on
        two ranks)."""
        if n % self.ranks:
            raise ValueError(f"the mesh's model degree {self.ranks} does "
                             f"not divide the {n} heads")
        return self.span(n)

    def gather(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's columns of ``n`` -> all ``n`` (``gather_cols``)."""
        return gather_cols(t, self.model, n)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """A partial sum over this rank's heads or channels -> the whole
        sum (an all-reduce over "model", in place)."""
        return sum_over(t, (self.model,))

    def whole_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's batch rows of ``t`` -> every row of the call (an
        all-gather over each data group, innermost first)."""
        for g in reversed(self.data):
            t = gather_rows(t, g)
        return t


def head_shard(part, batch: int) -> HeadShard:
    """The split of a call of ``batch`` rows over ``part``'s mesh: this
    rank's coordinate on "model", and its batch rows over the data axes
    as ``part.for_batch(batch)`` places them (a one-row batch, or one that
    does not split, stays whole there).  Without a mesh: the whole
    call."""
    if part.mesh is None:
        return HeadShard((0, batch))
    part = part.for_batch(batch)
    mesh = part.mesh
    m = tuple(mesh.mesh_dim_names).index("model")
    axes = part.spec(("batch",))[0] or ()
    axes = axes if isinstance(axes, tuple) else (axes,)
    return HeadShard(
        local_extent((batch,), part.sharding(("batch",)))[0],
        rank=mesh.get_coordinate()[m], ranks=mesh.size(m),
        model=mesh_group(mesh, "model"),
        data=tuple(g for g in (mesh_group(mesh, a) for a in axes)
                   if g is not None))
