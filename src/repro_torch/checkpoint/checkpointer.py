"""Atomic, async checkpointing in the JAX package's format — counterpart
of its ``checkpoint/checkpointer.py``.

Layout: ``<dir>/step_<N:08d>/`` with one ``.npy`` per tree leaf, named by
the first 16 hex digits of the sha1 of its flattened path (dict keys and
NamedTuple field names joined by ``/``, dict keys in sorted order), a
``manifest.json`` carrying each leaf's file, shape, dtype and the sha1 of
its bytes, and a ``COMMIT`` marker written last — a crashed writer never
produces a readable checkpoint (atomicity via marker + temp-dir rename).
``save_async`` copies the tree to the host before it returns and writes
on a thread, so the train loop overlaps I/O with compute.  ``restore``
verifies the hashes and returns tensors on the caller's device.

A bfloat16 leaf is written as its raw 2-byte patterns under the header
the reference's ``np.save`` writes for an ``ml_dtypes`` bfloat16 array
(``descr '<V2'``), with manifest dtype ``"bfloat16"``; on restore those
bytes are viewed as ``torch.bfloat16``.  So a checkpoint written by either
package restores in the port, and the two write the same bytes for the
same tree.  A DTensor leaf is saved whole (``full_tensor``), so a
checkpoint written on one mesh restores onto any other: ``restore(...,
shardings=)`` places each leaf on the given mesh (the elastic restart
path, ``runtime.elastic``).
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.partitioning import Sharding, is_dtensor, place
from repro_torch.tree import flatten as _flatten, unflatten as _unflatten

BF16 = "bfloat16"


def _key(path) -> str:
    return "/".join(path)


def _sharding_at(flat_sh, path):
    """The entry of a flattened sharding tree for the leaf at ``path``:
    its own, or a None written at a prefix of it.  A leaf the tree does
    not name raises (a param that ``param_shardings`` missed would
    otherwise come back whole among the DTensors)."""
    if path in flat_sh:
        return flat_sh[path]
    for n in range(len(path) - 1, -1, -1):
        if path[:n] in flat_sh and flat_sh[path[:n]] is None:
            return None
    raise ValueError(f"the shardings name no Sharding for {_key(path)}; "
                     f"write None there to restore it as like_tree has it")


def _mesh_of(tree):
    """The one mesh of a tree's DTensor leaves; ``None`` for a tree
    without any."""
    meshes = [v.device_mesh for v in _flatten(tree).values()
              if is_dtensor(v)]
    if not meshes:
        return None
    if any(m != meshes[0] for m in meshes[1:]):
        raise ValueError("a saved tree's DTensor leaves must share one "
                         "mesh")
    mesh = meshes[0]
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the saved tree's mesh: only "
                         "the mesh's ranks save it")
    return mesh


def _is_writer(mesh) -> bool:
    """The rank at mesh coordinate (0, ..., 0) writes a sharded save."""
    return not any(mesh.get_coordinate())


def _mesh_barrier(mesh):
    """One barrier per mesh dimension, in order, over the mesh's own
    groups: no rank leaves the last before every rank of the mesh has
    entered the first (ranks outside the mesh take no part)."""
    import torch.distributed as dist
    for d in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(d))


def to_host(leaf):
    """(numpy array, manifest dtype) of a leaf: a tensor's bytes on the
    host (a bfloat16 tensor's as int16 patterns), or ``np.asarray``."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        # a copy even on the CPU: an async write must not see later steps
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_npy(path: Path, arr: np.ndarray, dtype: str):
    if dtype != BF16:
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        # the mesh of a pending sharded ``save_async``: its ranks meet in
        # ``wait``
        self._mesh = None
        # one record per save and restore: {"op", "step", "bytes",
        # "seconds"} (a save's seconds cover the copy to the host and the
        # write; an async save's are recorded when its thread ends)
        self.log: list = []

    # ------------------------------------------------------------------ save
    def _host(self, tree):
        return {k: to_host(v) for k, v in _flatten(tree).items()}

    def save(self, step: int, tree) -> Path:
        """Write ``tree`` at ``step``.  A tree with DTensor leaves is saved
        by every rank of its mesh together: each leaf is gathered whole
        on every rank (a collective), the rank at mesh coordinate (0, ...,
        0) writes, and all wait for the write (``_mesh_barrier``) before
        they return."""
        self.wait()
        t0 = time.perf_counter()
        mesh = _mesh_of(tree)
        host = self._host(tree)
        if mesh is None:
            return self._write(step, host, t0)
        if _is_writer(mesh):
            self._write(step, host, t0)
        _mesh_barrier(mesh)
        return self.dir / f"step_{step:08d}"

    def save_async(self, step: int, tree) -> None:
        """``save`` with the write on a thread.  A DTensor tree is gathered
        before this returns; the writer's thread writes, and every rank
        of the mesh waits for it in the next ``wait`` (which ``save``,
        ``save_async`` and ``restore`` call first)."""
        self.wait()
        t0 = time.perf_counter()
        mesh = _mesh_of(tree)
        host = self._host(tree)            # transfer before returning
        self._mesh = mesh
        if mesh is not None and not _is_writer(mesh):
            return
        self._thread = threading.Thread(target=self._write,
                                        args=(step, host, t0), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            _mesh_barrier(mesh)

    def _write(self, step: int, host: Dict[tuple, Any], t0: float) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}}
        n_bytes = 0
        for path, (arr, dtype) in host.items():
            key = _key(path)
            fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
            _save_npy(tmp / fname, arr, dtype)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype,
                "sha1": hashlib.sha1(arr.tobytes()).hexdigest(),
            }
            n_bytes += arr.nbytes
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "COMMIT").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        self.log.append({"op": "save", "step": step, "bytes": n_bytes,
                         "seconds": time.perf_counter() - t0})
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMIT").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree, shardings=None,
                verify: bool = True, device=None):
        """Restore into the structure of ``like_tree``: a tensor leaf
        comes back as a tensor on ``device`` (default: that leaf's
        device), any other leaf as the numpy array the reference returns.
        ``shardings`` — a tree like ``like_tree`` of
        ``partitioning.Sharding`` (``placement_bridge.param_shardings``) —
        places every leaf as a DTensor on its mesh instead: each rank
        reads the whole leaf and keeps its slice (no collective).  A None
        written at a leaf, or at a prefix of its path, restores that leaf
        as ``like_tree`` has it (a train state's step counter, its data
        cursor); a leaf that ``shardings`` does not name raises
        ``ValueError``.  Raises ``IOError`` when a leaf's bytes do not
        match their sha1."""
        self.wait()
        t0 = time.perf_counter()
        src = self.dir / f"step_{step:08d}"
        manifest = json.loads((src / "manifest.json").read_text())
        flat_sh = None if shardings is None else _flatten(shardings)
        leaves, n_bytes = {}, 0
        for path, like in _flatten(like_tree).items():
            key = _key(path)
            meta = manifest["leaves"][key]
            arr = np.load(src / meta["file"])
            if verify:
                h = hashlib.sha1(arr.tobytes()).hexdigest()
                if h != meta["sha1"]:
                    raise IOError(f"checkpoint corruption at {key}")
            n_bytes += arr.nbytes
            sh = None if shardings is None else _sharding_at(flat_sh, path)
            if sh is not None or isinstance(like, torch.Tensor):
                if meta["dtype"] == BF16:
                    t = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
            if sh is not None:
                if not isinstance(sh, Sharding):
                    raise ValueError(
                        f"the sharding of {key} is a {type(sh).__name__}, "
                        f"not a partitioning.Sharding(mesh, placements)")
                leaves[path] = place(t, sh)
            elif isinstance(like, torch.Tensor):
                leaves[path] = t.to(like.device if device is None
                                    else torch.device(device))
            else:
                leaves[path] = arr
        self.log.append({"op": "restore", "step": step, "bytes": n_bytes,
                         "seconds": time.perf_counter() - t0})
        return _unflatten(like_tree, leaves)
