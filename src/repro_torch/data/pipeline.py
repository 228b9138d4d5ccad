"""Synthetic token data pipeline with a host-to-device prefetch thread —
counterpart of the JAX package's ``data/pipeline.py``.

``SyntheticLM`` is the reference's numpy stream unchanged: Zipf tokens
drawn with a per-step seed, so its batches equal the reference's bit for
bit and a restarted job resumes from its cursor.  ``ShardedPrefetcher``
copies each numpy batch to the device on a worker thread while the
previous step computes (pinned host memory and ``non_blocking`` copies on
CUDA), or with ``shardings`` places it as DTensors on a mesh, each rank
keeping its rows of the batch.  Both run on the GPU unless the caller
asks for the CPU.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.partitioning import Sharding, place


class SyntheticLM:
    """Deterministic synthetic next-token-prediction stream.

    Draws Zipf-distributed tokens (vocab-realistic) with a fixed per-step
    seed so a restarted job resumes bit-identically from the cursor —
    required for checkpoint/restart tests.
    """

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.2):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.zipf_a = zipf_a
        self.step = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: Dict[str, Any]):
        self.step = int(d["step"])
        self.seed = int(d["seed"])

    def _sample(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) + step)
        raw = rng.zipf(self.zipf_a,
                       size=(self.global_batch, self.seq_len + 1))
        toks = (raw - 1) % self.vocab_size
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = self._sample(self.step)
            self.step += 1        # advance BEFORE yielding: the cursor in
            yield batch           # state_dict() counts *consumed* batches


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: through pinned host memory
    and asynchronous copies on CUDA."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


class ShardedPrefetcher:
    """Host->device double-buffering: a worker thread materializes numpy
    batches and copies them to ``device`` (``None``: the GPU, raising
    where none is present) while the previous step computes.  With
    ``shardings`` ({name: ``partitioning.Sharding``}, e.g.
    ``placement_bridge.batch_shardings``) each batch becomes DTensors on
    that mesh instead: every rank draws the same batch from the seeded
    source and keeps its own rows, so placing needs no collective on the
    worker thread."""

    def __init__(self, source: Iterator[Dict[str, np.ndarray]],
                 shardings: Optional[Dict[str, Any]] = None,
                 depth: int = 2, device=None):
        if shardings is not None:
            bad = [k for k, v in shardings.items()
                   if not isinstance(v, Sharding)]
            if bad:
                raise ValueError(f"shardings of {bad} are not "
                                 f"partitioning.Sharding(mesh, placements)")
        self.source = source
        self.shardings = shardings
        self.device = None if shardings is not None \
            else resolve_device(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        for batch in self.source:
            if self._stop.is_set():
                return
            if self.shardings is not None:
                batch = {k: place(torch.from_numpy(np.ascontiguousarray(v)),
                                  self.shardings[k])
                         for k, v in batch.items()}
                self._q_put(batch)
                continue
            batch = to_device(batch, self.device)
            if self.device.type == "cuda":
                # the consumer's stream must not read before the copy lands
                torch.cuda.current_stream(self.device).synchronize()
            self._q_put(batch)

    def _q_put(self, batch):
        while not self._stop.is_set():
            try:
                self.q.put(batch, timeout=0.5)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                return self.q.get(timeout=1.0)
            except queue.Empty:
                if not self.thread.is_alive():
                    raise StopIteration
                continue

    def close(self):
        self._stop.set()


def make_train_pipeline(cfg, shape, shardings=None, seed: int = 0,
                        prefetch: bool = True, device=None):
    src = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch,
                      seed=seed)
    it = iter(src)
    if prefetch:
        return src, ShardedPrefetcher(it, shardings, device=device)
    return src, it
