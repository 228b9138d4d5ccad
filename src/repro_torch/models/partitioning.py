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
        holds it; ``broadcast_from``: under autograd the owner's input
        takes the gradient, the others none).  ``t`` itself where no owner
        is named."""
        if not self.owner:
            return t
        for name, coord in self.owner:
            t = broadcast_from(t, mesh_group(self.mesh, name), coord)
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

    def gather_params(self, tree):
        """A (nested dict) tree of parameters as a layer uses them: each
        DTensor leaf's shards over the storage axes (``fsdp_axes``: "data"
        under ``fsdp=True``, every axis under the zero3 layout) gathered —
        an all-gather, DTensor's ``redistribute``, whose backward brings
        the gradient back onto the shard (a reduce-scatter of a partial
        one).  Called inside a layer's activation checkpoint, a layer's
        weights are gathered on use and again in its backward.  Without a
        storage axis: ``tree`` itself."""
        fsdp = fsdp_axes(self)
        if not fsdp:
            return tree

        def one(t):
            if isinstance(t, dict):
                return {k: one(v) for k, v in t.items()}
            return _gathered(t, fsdp) if is_dtensor(t) else t
        return one(tree)

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


def local(x, partial: Sequence[str] = ()):
    """The rank's shard of a DTensor, or ``x`` itself (for ops without a
    DTensor rule: a custom kernel, a layer on local tensors).

    Under autograd the shard's gradient is read with ``x``'s placements,
    except over the mesh dimensions named in ``partial`` where ``x`` is
    replicated: there the rank's use of it is one part of work split over
    that dimension (its batch rows, its heads), so its gradient is a
    ``Partial`` sum, reduced over the dimension where it reaches ``x``.
    Without ``partial`` a replicated tensor's gradient counts as the same
    on every rank (Megatron's and DTensor's convention: work done alike
    on every rank)."""
    if not is_dtensor(x):
        return x
    names = tuple(x.device_mesh.mesh_dim_names)
    if not any(names[m] in partial and pl.is_replicate()
               for m, pl in enumerate(x.placements)):
        return x.to_local()
    from torch.distributed.tensor import Partial
    return x.to_local(grad_placements=tuple(
        Partial() if names[m] in partial and pl.is_replicate() else pl
        for m, pl in enumerate(x.placements)))


def fsdp_axes(part) -> Tuple[str, ...]:
    """The mesh dimensions ``part``'s rules store parameters over and
    gather them on use (the "fsdp" rule: "data" under ``fsdp=True``, every
    dimension under the zero3 layout); () without a mesh."""
    if part.mesh is None:
        return ()
    m = part.rules.get("fsdp")
    return () if m is None else (tuple(m) if isinstance(m, tuple) else (m,))


def use_placements(w, fsdp: Sequence[str]) -> tuple:
    """DTensor ``w``'s placements once its shards over the mesh dimensions
    ``fsdp`` are gathered: ``Replicate`` there, the rest kept."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(w.device_mesh.mesh_dim_names)
    return tuple(Replicate() if names[m] in fsdp and isinstance(pl, Shard)
                 else pl for m, pl in enumerate(w.placements))


def _gathered(w, fsdp: Sequence[str]):
    """DTensor ``w`` with its shards over ``fsdp`` gathered (DTensor's
    ``redistribute``: an all-gather, whose backward brings the gradient
    back onto the shard), or ``w`` itself where none shards it."""
    want = use_placements(w, fsdp)
    return w if want == tuple(w.placements) \
        else w.redistribute(w.device_mesh, want)


def gather_fsdp(w, fsdp: Sequence[str] = (), partial: Sequence[str] = ()):
    """A parameter as a layer on local tensors uses it: DTensor ``w``'s
    shards over the storage axes ``fsdp`` (``fsdp_axes``) gathered — an
    all-gather, DTensor's ``redistribute`` — and the result's local
    tensor, its gradient ``Partial`` over ``partial`` (``local``).  The
    backward is the gather's conjugate: a reduce-scatter of that partial
    gradient back onto the rank's shard (where the rank's work is split
    over the axis; a replicated gradient's chunk where every rank works
    alike).  A plain tensor comes back as it is, and a DTensor no storage
    axis shards is ``local`` alone, with no collective."""
    return local(_gathered(w, fsdp), partial) if is_dtensor(w) else w


def rows_of(t, rows: Tuple[int, int]):
    """Rows ``[lo, lo + n)`` of ``t``'s dimension 0 as a local tensor
    (``rows``: (lo, n), a ``HeadShard``'s): a DTensor's own shard where it
    holds just those rows (a batch the prefetcher placed), else cut from
    the whole."""
    lo, n = rows
    if is_dtensor(t):
        if local_range(t, 0) == (lo, n) and all(
                pl.is_replicate() or getattr(pl, "dim", None) == 0
                for pl in t.placements):
            return t.to_local()
        t = t.full_tensor()
    return t[lo:lo + n]


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


def _places(sh: Sharding, name: str, dim: int) -> bool:
    """Whether ``sh`` shards tensor dimension ``dim`` (>= 0) over mesh
    dimension ``name``."""
    from torch.distributed.tensor import Shard
    names = tuple(sh.mesh.mesh_dim_names)
    if name not in names:
        return False
    pl = sh.placements[names.index(name)]
    return isinstance(pl, Shard) and pl.dim == dim


def _shards(x, name: str, dim: int) -> bool:
    """Whether DTensor ``x`` shards its dimension ``dim`` over mesh
    dimension ``name``."""
    return is_dtensor(x) and _places(
        Sharding(x.device_mesh, tuple(x.placements)), name, dim % x.ndim)


# Collectives under autograd.  The layers on local tensors keep
# Megatron's convention, which is DTensor's: a tensor every rank of a
# group holds alike has the same, whole gradient on every rank; a tensor
# each rank holds a part of has on each rank the gradient of its part.  So
# a collective's backward depends on what its result feeds, and each call
# site says which (``redundant``): work every rank of the group does
# alike — the result's gradient is the same on every rank, and summing it
# over the ranks would count it once a rank — or work split over the
# group — each rank's gradient is a partial sum, its share.  Without
# autograd (a decode step) each function runs its collective alone, in
# place where it can.


def _grad_on(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _ranks(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_ranks(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    parts = [c.contiguous() for c in t.chunk(_ranks(group), dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed over each group in turn, in place."""
    import torch.distributed as dist
    for g in groups:
        if g is not None:
            dist.all_reduce(t, group=g)
    return t


def _pad_to(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to ``n``."""
    pad = n - t.shape[dim]
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _gather_pieces(t: torch.Tensor, group, dim: int, n: int):
    """Every rank's piece of ``n`` along ``dim`` (cut as ``torch.chunk``
    cuts it; a short last piece padded for the all-gather) put together
    in rank order."""
    chunk = -(-n // _ranks(group))
    return _all_gather(_pad_to(t, dim, chunk), group, dim).narrow(dim, 0, n)


class _Gather(torch.autograd.Function):
    """All-gather of ``torch.chunk``-cut pieces of ``n`` along ``dim``.
    Backward: a reduce-scatter where the result feeds split work (each
    rank's gradient is a partial sum: the rank's piece takes the sum of
    every rank's gradient of it), the rank's own piece of the gradient
    where every rank uses the result alike (``redundant``)."""

    @staticmethod
    def forward(ctx, t, group, dim, n, redundant):
        import torch.distributed as dist
        ctx.args = (group, dim, redundant, -(-n // _ranks(group)),
                    t.shape[dim], dist.get_rank(group))
        return _gather_pieces(t, group, dim, n)

    @staticmethod
    def backward(ctx, g):
        group, dim, redundant, chunk, mine, rank = ctx.args
        g = _pad_to(g, dim, chunk * _ranks(group))
        own = g.narrow(dim, rank * chunk, chunk) if redundant \
            else _reduce_scatter(g, group, dim)
        return own.narrow(dim, 0, mine), None, None, None, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter along ``dim``.  Backward: an all-gather — every
    rank's addend takes the whole result's gradient."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Sum(torch.autograd.Function):
    """All-reduce (a sum of partials) over ``groups`` in turn.  Backward:
    the identity where every rank then uses the sum alike (Megatron's
    "g": its gradient is already the whole one on each rank), an
    all-reduce where the sum feeds split work (each rank's gradient of it
    is a partial)."""

    @staticmethod
    def forward(ctx, t, groups, redundant):
        ctx.groups, ctx.redundant = groups, redundant
        return _all_reduce(t.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        if ctx.redundant:
            return g, None, None
        return _all_reduce(g.clone(), ctx.groups), None, None


class _Enter(torch.autograd.Function):
    """The entry of a tensor every rank holds alike into work split over
    ``groups`` (Megatron's "f"): the identity.  Backward: an all-reduce —
    each rank's gradient is its part's share, and the whole is their
    sum."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.groups), None


class _Broadcast(torch.autograd.Function):
    """Broadcast from global rank ``src`` over ``group``.  Backward: at
    the source, the gradient itself where every rank uses the result
    alike (``redundant``: it is the whole one on each rank) or its sum
    over the group, a reduce to the source, where the result feeds split
    work; zeros on the other ranks, whose input was not used."""

    @staticmethod
    def forward(ctx, t, group, src, redundant):
        import torch.distributed as dist
        ctx.args = (group, src, redundant, dist.get_rank() == src)
        out = t.contiguous().clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        group, src, redundant, mine = ctx.args
        g = g.contiguous().clone()
        if not redundant:
            dist.reduce(g, dst=src, group=group)
        return (g if mine else torch.zeros_like(g)), None, None, None


def gather_rows(t: torch.Tensor, group, *,
                redundant: bool = False) -> torch.Tensor:
    """Every rank of ``group``'s ``t``, stacked along dimension 0 in rank
    order (an all-gather); ``t`` itself without a group.  Backward: a
    reduce-scatter where the rows feed work split over the group (a MoE
    layer's expert rows), each rank's own rows of the gradient where
    every rank uses them alike (``redundant``: whole logits)."""
    if group is None:
        return t
    if _grad_on(t):
        return _Gather.apply(t, group, 0, t.shape[0] * _ranks(group),
                             redundant)
    return _all_gather(t, group, 0)


def scatter_rows_sum(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``t``, each rank keeping its
    chunk of dimension ``dim`` in rank order (a reduce-scatter: the way
    back of ``gather_rows`` for partial sums; along the sequence, the exit
    of a sequence-parallel region); ``t`` itself without a group.
    Backward: an all-gather of the chunks' gradients."""
    if group is None:
        return t
    if _grad_on(t):
        return _ScatterSum.apply(t, group, dim)
    return _reduce_scatter(t, group, dim)


def sum_over(t: torch.Tensor, groups, *,
             redundant: bool = True) -> torch.Tensor:
    """``t`` summed over the ranks of each group in turn (an all-reduce
    each; None entries skipped).  Without autograd in place, returning
    ``t``; under it a new tensor, whose backward is the identity where
    every rank then uses the sum alike (``redundant``) and an all-reduce
    where it feeds work split over the groups."""
    groups = tuple(g for g in groups if g is not None)
    if groups and _grad_on(t):
        return _Sum.apply(t, groups, redundant)
    return _all_reduce(t, groups)


def enter_split(t: torch.Tensor, groups) -> torch.Tensor:
    """``t``, held alike by every rank of ``groups``, entering work split
    over them: the identity, whose backward all-reduces the ranks'
    partial gradients (nothing to do without autograd or a group)."""
    groups = tuple(g for g in groups if g is not None)
    if groups and _grad_on(t):
        return _Enter.apply(t, groups)
    return t


def broadcast_from(t: torch.Tensor, group, coord: int, *,
                   redundant: bool = True) -> torch.Tensor:
    """Rank ``coord`` of ``group``'s ``t`` on every rank of it (a
    broadcast; ``t`` itself without a group).  Backward (``_Broadcast``):
    at the source, the gradient itself where every rank uses the result
    alike (``redundant``), else a reduce to the source."""
    if group is None:
        return t
    import torch.distributed as dist
    src = dist.get_global_rank(group, coord)
    if _grad_on(t):
        return _Broadcast.apply(t, group, src, redundant)
    t = t.contiguous()
    dist.broadcast(t, src=src, group=group)
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
    them, ``token_ranks`` ranks in all; ``token_axes`` their names).
    ``fsdp`` names the axes the parameters are stored over and gathered
    from on use (``fsdp_axes``).  Without a mesh: every row, no group.

    Under autograd the routing runs alike on the ranks of ``ff`` (and of
    ``experts`` where the batch stays whole), so its gradient is the same
    there; the tokens and gates enter the expert rows' work through
    ``enter`` (Megatron's "f"), the gathered tokens' gradient comes back
    by a reduce-scatter, and the summed output's by the identity
    (``sum_partials``)."""
    lo: int
    n: int
    gather: Optional[object] = None
    experts: Optional[object] = None
    ff: Optional[object] = None
    tokens: tuple = ()
    token_ranks: int = 1
    token_axes: tuple = ()
    fsdp: tuple = ()

    def param(self, w):
        """A layer parameter as this rank computes with it
        (``gather_fsdp``): its storage shards gathered, its gradient
        partial over the token axes (the rank's tokens are a part of the
        call's)."""
        return gather_fsdp(w, self.fsdp, self.token_axes)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (tokens or gates, held alike over the d_ff slices and,
        where the batch stays whole on it, the expert rows' group)
        entering the expert rows' work: ``enter_split`` over those
        groups."""
        return enter_split(t, (self.ff,) if self.gather is not None
                           else (self.ff, self.experts))

    def gather_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """(B, ...) rows of this rank's tokens -> the rows of every rank
        of ``gather``, whose tokens this rank's experts also serve (their
        gradient comes back by a reduce-scatter)."""
        return gather_rows(t, self.gather)

    def sum_partials(self, out: torch.Tensor,
                     seq_out: bool = False) -> torch.Tensor:
        """The layer's output on this rank's tokens from its partial one
        (its expert rows and d_ff slice over the gathered tokens): summed
        over the expert ranks — scattered back to each rank's tokens where
        they were gathered — and over the d_ff slices; every rank of a sum
        uses it alike (identity backward).  ``seq_out`` (sequence
        parallelism: the residual's sequence lies over "model"): the sum
        over the d_ff slices is a reduce-scatter along the sequence
        instead, each rank keeping its chunk (Megatron's exit of a
        sequence-parallel region; an all-gather backward)."""
        if self.gather is not None:
            out = scatter_rows_sum(out, self.gather)
        elif self.experts is not None:
            out = sum_over(out, (self.experts,))
        if seq_out:
            return scatter_rows_sum(out, self.ff, dim=1)
        return sum_over(out, (self.ff,))

    def sum_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's tokens -> the sum over every token of
        the call (in place without autograd; every rank uses it alike)."""
        return sum_over(t, self.tokens)

    def sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A count over this rank's (token, expert row) pairs -> the count
        over every pair of the call (in place): over the expert rows'
        ranks and the ranks of other tokens, each once."""
        groups = self.tokens
        if self.experts is not None and self.gather is None:
            groups = groups + (self.experts,)
        return sum_over(t, groups)


def expert_shard(x, w, part=None) -> ExpertShard:
    """The split of a MoE layer with input ``x`` (B, S, D) and expert
    stack ``w`` (..., Ep, D, F) — its ``w_gate`` — over their mesh: the
    expert rows ``w``'s shard holds (sharded over "pod" by
    ``placement_bridge.param_spec`` where the mesh has one), whether its
    d_ff slice is one of several ("model"), and which mesh dimensions
    shard ``x``'s batch rows (``Partitioner.for_batch`` keeps a batch whole
    there: every rank already holds every token, and nothing is
    gathered).  ``part``'s rules name the storage axes (``fsdp_axes``):
    the split is read off ``w``'s placements once those are gathered, so
    the zero3 layout, which stores every parameter over every axis,
    computes every expert row with the whole d_ff on each rank's tokens.
    A plain ``x``: every row, no group."""
    if not is_dtensor(x):
        return ExpertShard(0, w.shape[-3])
    mesh = x.device_mesh
    fsdp = fsdp_axes(part) if part is not None else ()
    used = Sharding(mesh, use_placements(w, fsdp))
    lo, n = local_extent(w.shape, used)[w.ndim - 3]
    experts = mesh_group(mesh, "pod") if _places(used, "pod", w.ndim - 3) \
        else None
    tokens = [name for name in mesh.mesh_dim_names
              if _shards(x, name, 0) and mesh_group(mesh, name) is not None]
    return ExpertShard(
        lo, n,
        gather=experts if "pod" in tokens else None, experts=experts,
        ff=mesh_group(mesh, "model") if _places(used, "model", w.ndim - 1)
        else None,
        tokens=tuple(mesh_group(mesh, name) for name in tokens),
        token_ranks=int(np.prod([_size(mesh, name) for name in tokens])),
        token_axes=tuple(name for name in mesh.mesh_dim_names
                         if _shards(x, name, 0)),
        fsdp=fsdp)


# ---------------------------------------------------------------------------
# Sequence parallelism of a KV cache: attention over a rank's positions
# ---------------------------------------------------------------------------

# the log-sum-exp of a row with no valid key: weight 0 in a merge, never NaN
EMPTY_LSE = -1e30


def merge_partials(out: torch.Tensor, lse: torch.Tensor,
                   dtype=None) -> torch.Tensor:
    """Attention over a whole sequence from its shards' partials, stacked
    along dimension 0: ``out`` (n, ..., dh) each shard's float32 softmax
    output over its own keys, ``lse`` (n, ...) the log-sum-exp of its
    scores (``EMPTY_LSE`` where it holds no valid key).  With ``M`` the
    largest LSE, the whole call's output is ``sum exp(lse - M) · out /
    sum exp(lse - M)``, cast to ``dtype`` once (float32 by default).  The
    local form of :meth:`SeqShard.merge`; a shard that holds every valid
    key (the others ``EMPTY_LSE``) comes back bit for bit."""
    m = lse.amax(dim=0)
    w = torch.exp(lse - m)
    num = (out * w[..., None]).sum(dim=0)
    return (num / w.sum(dim=0)[..., None]).to(dtype or torch.float32)


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """How attention over a KV cache whose sequence (or ring slots) is
    sharded over a mesh's data axis splits (``seq_shard``; the
    ``seq_over_data`` rules of the reference's long-decode cells): this
    rank holds positions (or slots) ``[lo, lo + n)`` of ``total``, cut as
    ``torch.chunk`` cuts them (the way DTensor shards; a last shard may be
    short or empty), and ``group`` is the data axis's group, whose ranks
    hold the rest.  A rank writes only the positions it owns, attends over
    them alone — its softmax's float32 output and log-sum-exp — and the
    ranks merge the partials (``merge``): two small collectives, no K or
    V.  Without a group (one data rank) the merge is the identity."""
    lo: int
    n: int
    total: int
    group: Optional[object] = None

    def owns(self, pos: int) -> bool:
        """Whether position (or slot) ``pos`` lies in this rank's shard."""
        return self.lo <= pos < self.lo + self.n

    def span(self, start: int, count: int) -> Tuple[int, int]:
        """(first, count) of ``[start, start + count)`` that this rank
        holds (count 0 where none)."""
        a = max(start, self.lo)
        b = min(start + count, self.lo + self.n)
        return a, max(b - a, 0)

    def local_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        """A decode kernel's valid lengths (a prefix of the whole cache)
        as lengths of this rank's shard: ``clamp(len - lo, 0, n)``."""
        return (lengths - self.lo).clamp(0, self.n)

    def merge(self, out: torch.Tensor, lse: torch.Tensor,
              dtype=None) -> torch.Tensor:
        """This rank's partials ``out`` (..., dh) float32 and ``lse`` (...)
        -> the whole call's output, the same on every rank of ``group``,
        cast to ``dtype`` once: the LSE's max over the group (one
        all-reduce), then ``exp(lse - max) · out`` beside ``exp(lse -
        max)`` summed over it (a second).  :func:`merge_partials` is the
        same arithmetic on partials stacked in one process."""
        if self.group is None:
            return merge_partials(out[None], lse[None], dtype)
        import torch.distributed as dist
        m = lse.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        w = torch.exp(lse - m)
        both = torch.cat([(out * w[..., None]).reshape(-1), w.reshape(-1)])
        dist.all_reduce(both, group=self.group)
        num = both[:out.numel()].view(out.shape)
        den = both[out.numel():].view(w.shape)
        return (num / den[..., None]).to(dtype or torch.float32)


def seq_shard(part, cache: torch.Tensor, dim: int = 1) -> Optional[SeqShard]:
    """The sequence split of attention over ``cache`` (a layer's K buffer,
    (B, T, KvE, dh) or a ring's (B, W, KvE, dh)) under ``part``: None
    unless ``part``'s rules put "cache_seq" on a mesh axis
    (``make_partitioner(seq_over_data=True)``); else this rank's
    ``[lo, lo + n)`` of dimension ``dim`` (``local_range``) and that
    axis's group (None where it holds one rank)."""
    axis = part.rules.get("cache_seq") if part.mesh is not None else None
    if axis is None:
        return None
    lo, n = local_range(cache, dim)
    return SeqShard(lo, n, cache.shape[dim], mesh_group(part.mesh, axis))


# ---------------------------------------------------------------------------
# Head parallelism of the recurrent families: layers on local tensors
# ---------------------------------------------------------------------------

def gather_cols(t: torch.Tensor, group, n: int, *,
                redundant: bool = False) -> torch.Tensor:
    """Every rank of ``group``'s chunk of the last dimension — cut from
    ``n`` columns as ``torch.chunk`` cuts them, the way DTensor shards —
    put together in rank order: the whole ``n`` columns on every rank (an
    all-gather; a short last chunk is padded for it and trimmed after).
    ``t`` itself without a group.  Backward: a reduce-scatter where the
    columns feed work split over the group (a Mamba-2 block's heads), the
    rank's own columns of the gradient where every rank uses them alike
    (``redundant``: RWKV-6's receptance gate, whole logits)."""
    if group is None:
        return t
    if _grad_on(t):
        return _Gather.apply(t, group, t.dim() - 1, n, redundant)
    return _gather_pieces(t, group, t.dim() - 1, n)


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
    the groups of the mesh dimensions that split the batch, outermost
    first, and ``batch_axes`` their names.  ``fsdp`` names the axes the
    parameters are stored over, gathered on use (``param``).  Without a
    mesh: every head and row, no group.

    Under autograd a layer's residual stream is held alike by the ranks
    of "model": a block's split work starts with ``enter`` (Megatron's
    "f") and ends with ``reduce`` (its "g"), and a parameter used inside
    it has a gradient partial over "model" as well as over the batch axes
    (``param(w, split=True)``)."""
    rows: Tuple[int, int]
    rank: int = 0
    ranks: int = 1
    model: Optional[object] = None
    data: tuple = ()
    batch_axes: tuple = ()
    fsdp: tuple = ()

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

    def partial(self, split: bool) -> tuple:
        """The mesh dimensions over which a parameter's use is one part
        of the call's work: the batch axes, and "model" inside a block's
        split work (``split``)."""
        return self.batch_axes + (("model",) if split and self.ranks > 1
                                  else ())

    def stack(self, w, split: bool = True):
        """A stacked (L, ...) parameter for a layer loop: its local
        tensor (``local``, gradient placements as ``param`` gives them)
        where no storage axis shards it, else ``w`` itself, a DTensor
        that ``param`` gathers layer by layer (inside the layer's
        activation checkpoint: gathered again in its backward)."""
        if is_dtensor(w) and use_placements(w, self.fsdp) == tuple(
                w.placements):
            return local(w, self.partial(split))
        return w

    def param(self, w, split: bool = True):
        """A parameter (a layer's view) as this rank computes with it:
        ``gather_fsdp`` with the gradient partial over ``partial(split)``;
        a plain tensor (``stack``'s local tensor) as it is."""
        return gather_fsdp(w, self.fsdp, self.partial(split))

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, the same on every rank of "model", entering a block's
        work split over it (``enter_split``)."""
        return enter_split(t, (self.model,))

    def gather(self, t: torch.Tensor, n: int, *,
               redundant: bool = False) -> torch.Tensor:
        """This rank's columns of ``n`` -> all ``n`` (``gather_cols``)."""
        return gather_cols(t, self.model, n, redundant=redundant)

    def reduce(self, t: torch.Tensor, *,
               redundant: bool = True) -> torch.Tensor:
        """A partial sum over this rank's heads or channels -> the whole
        sum (an all-reduce over "model", in place without autograd;
        ``sum_over``)."""
        return sum_over(t, (self.model,), redundant=redundant)

    def whole_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's batch rows of ``t`` -> every row of the call (an
        all-gather over each batch group, innermost first), which every
        rank then uses alike."""
        for g in reversed(self.data):
            t = gather_rows(t, g, redundant=True)
        return t


def head_shard(part, batch: int) -> HeadShard:
    """The split of a call of ``batch`` rows over ``part``'s mesh, read
    from ``part``'s rules: the heads ("ssm_heads") over "model" — this
    rank's coordinate there — or over nothing (the zero3 layout: every
    rank computes every head), and the batch rows over the mesh
    dimensions the "batch" rule names, as ``part.for_batch(batch)`` places
    them (a one-row batch, or one that does not split, stays whole
    there).  Without a mesh: the whole call."""
    if part.mesh is None:
        return HeadShard((0, batch))
    part = part.for_batch(batch)
    mesh = part.mesh
    heads = part.rules.get("ssm_heads")
    if heads not in (None, "model"):
        raise ValueError(f"a recurrent layer splits its heads over "
                         f"\"model\" or nothing; the rules say {heads!r}")
    rank, ranks = 0, 1
    if heads is not None:
        m = tuple(mesh.mesh_dim_names).index("model")
        rank, ranks = mesh.get_coordinate()[m], mesh.size(m)
    axes = part.spec(("batch",))[0] or ()
    axes = axes if isinstance(axes, tuple) else (axes,)
    return HeadShard(
        local_extent((batch,), part.sharding(("batch",)))[0],
        rank=rank, ranks=ranks,
        model=mesh_group(mesh, "model") if heads is not None else None,
        data=tuple(g for g in (mesh_group(mesh, a) for a in axes)
                   if g is not None),
        batch_axes=tuple(axes), fsdp=fsdp_axes(part))
