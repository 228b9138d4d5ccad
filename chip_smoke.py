#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, started together), holds each against its plain
PyTorch version at the main paths' shapes, drives the main paths —
``ServingEngine(use_kernel=True)`` serving llama3-8b at full width (depth
cut to 4 layers, random weights from a seed) under continuous batching
with Algorithm 1 placements applied as live head migrations, from a
dense, a paged, an int8 and an int8 paged KV cache; ``make_engine(mode=
"auto")`` serving mixtral-8x7b at full width (4 layers) from its
sliding-window ring cache under the wave scheduler, with head and expert
migrations applied; and ``make_engine(mode="auto")`` serving the
attention-free rwkv6-7b at full width (4 layers) under the wave
scheduler, prefill and decode through the WKV6 kernel, with the
controller's head plans logged as not applied; and ``make_engine(mode=
"auto")`` serving glm4-9b (QKV bias set to seeded random values, half-head
RoPE) at full width (4 layers) under continuous batching with 2048-8192
token prompts and applied head migrations; and ``make_engine(mode="auto")``
serving musicgen-large (MHA at dh 64, LayerNorm, GELU, their biases set to
seeded random values) at full width (4 layers) on the dense path's traffic
— and checks that each path went through its kernels, with exact launch
counts.  It then serves a seeded Poisson load on the paged llama3-8b
engine through ``drive_virtual``, the same load through
``AsyncServingEngine`` (bf16 streams equal to ``drive_virtual``'s), and
the load with a device failing mid-decode and rejoining on the paged and
dense engines (evacuation and teacher-forced replay, launch counts exact
with the replay).  Every prefill whose queries and keys share their positions
(bucketed, lock-step, ring) runs the flash attention kernel.  It checks
that the paged decode kernels give the linear ones' output bit for bit on
the same cache in scrambled pages, and in float32 that greedy streams
with and without the kernels, from paged and dense caches, and with and
without a device failure or slowdown, are equal.

    python3 chip_smoke.py --ab build/parent . . build/parent

times the kernels of several checkouts in turns instead (see ``ab``).

Output: progress lines, then the card's ``name, power.limit`` line, a JSON
line ``{"kernels": [...]}`` with each kernel's launches on the main path,
error, times and bound, and last ``{"ok": true, "device": {...}}``.  Any
failed phase raises, exiting non-zero before the result lines.  Without a
GPU, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense FLOP/s by type
# (float32 on the CUDA cores; TF32 on the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12

MAIN_B, MAIN_H, MAIN_KVE, MAIN_DH, MAIN_T = 8, 32, 8, 128, 1024
N_LAYERS = 4
# the mixtral ring path: 4 slots, a 4096-token window, 4096-token prompts
RING_B, RING_W, RING_PROMPT, RING_NEW = 4, 4096, 4096, 64
# the rwkv6 path: 8 slots, 64 WKV heads of 64, 1024-token prompts; the
# kernel runs once per layer at prefill (S = prompt) and every decode step
RWKV_B, RWKV_H, RWKV_DH, RWKV_PROMPT, RWKV_NEW = 8, 64, 64, 1024, 64
# the WKV6 kernel's chunk: S >= 16 runs its chunked body, S < 16 steps
RWKV_CHUNK = 16
# the WKV6 kernel and its plain version both compute in float32 from the
# same inputs: summation order only, over up to 1024 dependent steps
RWKV_TOL = dict(atol=1e-4, rtol=1e-4)
NO_HEADS = "model has no addressable attention heads"
# the glm4 path: 8 slots, 16 prompts of 2048-8192 tokens, 64 new tokens
# each, an extent of 8264; every prompt bucket is 2048, 4096 or 8192
GLM_B, GLM_LO, GLM_HI, GLM_NEW, GLM_MAX_SEQ = 8, 2048, 8192, 64, 8264
# prefill attention through the flash kernel, per main path: one launch
# per layer for each bucketed prefill (16 requests) or lock-step wave
# (mixtral: 2); the paged chunk prefill and rwkv6 have no such attention
FLASH_LAUNCHES = {"dense": 16 * N_LAYERS, "paged": 0,
                  "int8": 16 * N_LAYERS, "int8_paged": 0,
                  "mixtral": 2 * N_LAYERS, "rwkv6": 0,
                  "glm4": 16 * N_LAYERS, "musicgen": 16 * N_LAYERS}
TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5),   # summation order
        # bf16 output keeps ~3 significant digits of values <~ 1
        torch.bfloat16: dict(atol=2e-2, rtol=0.0)}
# The flash phase also bounds each query row's relative error
# ||out_r - want_r|| / ||want_r||: a row over i keys of N(0, 1) inputs has
# outputs of ~sqrt(e / i), 0.03 at S 8192, so TOLS's bf16 atol alone
# passes a kernel that drops a K/V tile in late rows (PERF.md, PR 15).
FLASH_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The ring phase bounds each (b, resident row) the same way: over a full
# window of 4096 N(0, 1) slots an output is ~sqrt(e / 4096) = 0.026, as
# large as TOLS's bf16 atol.  Sound bf16 rows read <= 1.1e-3 (one bf16
# rounding of the output bounds them near 2e-3); copies that skip one
# split in the merge or zero one 16-byte piece of each K row read
# 0.34-0.58 (PERF.md, PR 16).
RING_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The split body's entry points (resident, int8, paged, int8-paged) are
# bounded per (b, resident row) the same way: over T 1024 of N(0, 1)
# inputs an output is ~sqrt(e / 1024) = 0.05, so TOLS's bf16 atol alone
# passes a kernel that drops a K/V tile or a split.  Sound bf16 rows read
# <= 3.6e-3 (the tensor cores round P to bf16), f32 rows <= 7e-7; copies
# whose merge skips one split read >= 0.57 and copies that zero one
# 16-byte piece of each K row >= 0.32 (PERF.md, "split body").
DECODE_ROW_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the glm4 path's decode: 32 q heads over 2 KV heads (G 16), an extent of
# GLM_MAX_SEQ, every row between its shortest prompt and its last token
GLM_DECODE = dict(B=8, H=32, KvE=2, dh=128, T=GLM_MAX_SEQ)
GLM_DECODE_LENGTHS = [8256, 2048, 5000, 7777, 3333, 6144, 4097, 8000]
# the musicgen path's decode: 32 q heads over 32 KV heads (MHA, G 1) at dh
# 64 over the dense path's extent
MG_DECODE = dict(B=MAIN_B, H=32, KvE=32, dh=64, T=MAIN_T)
DTYPE_NAMES = {"bfloat16": "bf16", "float32": "f32"}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def row_rel_err(out, want) -> float:
    """The worst row's ||out_r - want_r|| / ||want_r||, in float32, a row
    being the last axis (flash: a (b, h, query row); the ring: a (b,
    resident row)); a row whose ``want`` is zero counts its error's
    norm."""
    diff = (out.float() - want.float()).norm(dim=-1)
    norm = want.float().norm(dim=-1)
    return torch.where(norm > 0, diff / norm, diff).max().item()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(calls, reps: int = 20, n: int = 50) -> float:
    """Device milliseconds of one call.  ``calls`` are zero-argument
    callables on distinct input copies, together larger than the 50 MB L2,
    so each call finds its inputs cold as the main path does (a layer's
    cache is evicted by the rest of the step).  ``reps`` calls, cycling
    over the copies, are captured in one CUDA graph, so host launch
    overhead is out of the measurement; each of ``n`` replays is timed
    between CUDA events after warm-up, and the median over replays is
    divided by ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:                       # lazy init outside capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)) / reps


# the split bodies' mangled names: q's type (the tensor-core body's is
# bf16 and not in its name), then KVSource<E, PAGED, QUANT> and DH; the ring
# kernel's and the merge's: q's type and DH; the WKV6 bodies' (per-step or
# chunked): r/k/v's type, u's type and DH; the flash bodies': DH
_QTYPE = re.compile(r"decode_(split|split_mma)_kernelI"
                    r"(f|13__nv_bfloat16|NS_8KVSourceI13__nv_bfloat16)")
_FLAGS = re.compile(r"Lb([01])ELb([01])EEELi(\d+)E")
_RING = re.compile(r"(ring_split|split_merge)_kernelI(f|13__nv_bfloat16)"
                   r"Li(\d+)E")
_RWKV = re.compile(r"rwkv6_(step_|chunk_)?kernelI(f|13__nv_bfloat16)"
                   r"(f|13__nv_bfloat16|S\d*_)Li(\d+)E")
_FLASH = re.compile(r"flash_(simt|wgmma)_kernelILi(\d+)E")
_FLASH_KIND = {"simt": "f32", "wgmma": "bf16 wgmma + TMA"}


def ptxas_usage(text: str):
    """(kernel variant, registers and spills) per entry function in nvcc's
    ``-Xptxas -v`` output; the variant names the K/V source (linear,
    paged, int8; the ring's split and merge kernels), q's type and dh when
    the mangled name reads as a decode kernel's, the flash body and dh for
    flash, else the mangled name."""
    out, name, spills = [], None, ""
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name, spills = entry.group(1), ""
            continue
        if "spill stores" in line:
            spills = line.split(",", 1)[-1].strip()
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            qt, flags = _QTYPE.search(name), _FLAGS.search(name)
            ring = _RING.search(name)
            wkv = _RWKV.search(name)
            flash = _FLASH.search(name)
            if flash:
                kind, dh = flash.groups()
                name = f"flash, {_FLASH_KIND[kind]}, dh={dh}"
            elif ring:
                part, qt_, dh = ring.groups()
                part = "ring split" if part == "ring_split" else "merge"
                if part == "merge":
                    part += " (split body)" if "ELb1E" in name else " (ring)"
                name = (f"{part}, {'f32' if qt_ == 'f' else 'bf16'} q, "
                        f"dh={dh}")
            elif wkv:
                body, rt, ut, dh = wkv.groups()
                ut = rt if ut.startswith("S") else ut   # the same type again
                body = "chunked" if body == "chunk_" else "per-step"
                name = (f"rwkv6 {body}, {'f32' if rt == 'f' else 'bf16'} "
                        f"r/k/v, {'f32' if ut == 'f' else 'bf16'} u, "
                        f"dh={dh}")
            elif qt and flags:
                paged, quant, dh = flags.groups()
                kind = ("paged " if paged == "1" else "linear ") \
                    + ("int8" if quant == "1" else "fp")
                body = {"split": "split", "split_mma": "split mma"}[
                    qt.group(1)]
                q = "f32" if qt.group(2) == "f" else "bf16"
                name = f"{body} {kind}, {q} q, dh={dh}"
            out.append((name, f"{used.group(1)} registers, {spills}"))
            name = None
    return out


def log_ptxas(logs):
    """Each built kernel's registers and spills, and any note that ptxas
    lost performance (e.g. wgmma serialized, C7520)."""
    for text in logs.values():
        for variant, usage in ptxas_usage(text):
            log(f"  ptxas: {variant}: {usage}")
        for line in text.splitlines():
            if "Performance Loss" in line:
                log(f"  ptxas: {line.strip()}")


def check_flash_sass():
    """The built flash library's SASS must hold warpgroup MMA (``HGMMA``):
    the bf16 prefill runs on wgmma.  Returns the count of
    HGMMA instructions."""
    from repro_torch.kernels import build
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    n = len(re.findall(r"\bHGMMA\.", sass))
    check(n > 0, "the flash library's SASS holds no HGMMA instruction")
    return n


# ---------------------------------------------------------------- phase 2
def _group_perm(rng, H, G):
    groups = rng.permutation(H // G)
    return np.concatenate([g * G + rng.permutation(G) for g in groups])


def decode_inputs(dtype, *, B=MAIN_B, H=MAIN_H, KvE=MAIN_KVE, dh=MAIN_DH,
                  T=MAIN_T, rows="identity", lengths=None, seed=0):
    """Kernel-layout inputs; K/V are transposed views of a cache in the
    model's (B, T, KvE, dh) layout, as the main path passes them."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    kc = torch.from_numpy(rng.standard_normal((B, T, KvE, dh), np.float32))
    vc = torch.from_numpy(rng.standard_normal((B, T, KvE, dh), np.float32))
    if lengths is None:
        lengths = rng.integers(0, T + 2, B)
    if rows == "identity":
        r = np.arange(H)
    elif rows == "group_perm":
        r = _group_perm(rng, H, H // KvE)
    else:                                      # a partial slice, R = 8
        r = rng.choice(H, size=8, replace=False)
    as_dev = lambda t: t.to(dev, dtype)
    return (as_dev(q), as_dev(kc).transpose(1, 2), as_dev(vc).transpose(1, 2),
            torch.as_tensor(np.asarray(lengths), dtype=torch.int32,
                            device=dev),
            torch.as_tensor(r, dtype=torch.int32, device=dev))


def decode_bound_ms(q, lengths, rows, KvE, T, row_bytes=None, valid=None,
                    extra_bytes=0):
    """Least time for the function on these inputs: each valid K/V row
    (``row_bytes`` each, default dh in q's dtype) read once, q read, output
    written; ~4 flop per K/V element per row.  ``valid`` counts the valid
    (batch row, position) pairs (default: the clamped lengths);
    ``extra_bytes`` are other inputs read once."""
    B, H, dh = q.shape
    R = rows.shape[0]
    item = q.element_size()
    if valid is None:
        valid = int(lengths.clamp(0, T).sum())
    row_bytes = dh * item if row_bytes is None else row_bytes
    nbytes = valid * KvE * row_bytes * 2 + (B * H * dh + B * R * dh) * item \
        + 4 * (B + 2 * R) + extra_bytes
    flops = valid * R * dh * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sdpa_decode(q, k, v, lens, rows):
    """Yardstick only: one library call computing the resident kernel's
    function on the gathered q and the length-masked K/V (grouped query
    heads where the rows outnumber the KV heads)."""
    T = k.shape[2]
    mask = (torch.arange(T, device=q.device)[None, :]
            < lens.clamp(0, T)[:, None])[:, None, None, :]
    qs = q.index_select(1, rows.long())[:, :, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask, enable_gqa=qs.shape[1] != k.shape[1])


def phase_kernel_vs_plain():
    """The resident kernel against its plain version at the dense path's
    shapes (bf16 and f32; identity, group-permuted and partial rows;
    lengths 0, 1, T-1, T, T+1 and between, over 8 splits), the other head
    widths, the glm4 path's decode shape (G 16, 33 splits), and MHA (G 1:
    one q row a KV head) at the musicgen path's shape (dh 64) and
    qwen1.5-32b's heads (40 at dh 128), each held to TOLS and to
    DECODE_ROW_REL per (b, resident row); then its times at the dense
    shape (ragged and full lengths), the glm4 shape and the musicgen shape
    beside the plain version, SDPA and the bound.  The dense shape's go
    into the record, every shape's into its ``shapes``."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_resident, decode_attention_resident_plain)
    lengths = [0, 1, MAIN_T - 1, MAIN_T, MAIN_T + 1, 37, 512, 700]
    cases = [(dt, rows, dict(lengths=lengths))
             for dt in (torch.float32, torch.bfloat16)
             for rows in ("identity", "group_perm", "partial")]
    # the other head widths the wrapper accepts, at small shapes
    cases += [(torch.float32, "group_perm",
               dict(dh=dh, T=96, lengths=[0, 1, 95, 96, 97, 50, 3, 64]))
              for dh in (16, 32, 64)]
    # glm4's decode: 16 q heads a KV head, rows on split edges (256)
    cases += [(torch.bfloat16, "identity",
               dict(GLM_DECODE, lengths=GLM_DECODE_LENGTHS)),
              (torch.float32, "group_perm",
               dict(GLM_DECODE, lengths=[0, 1, 8264, 8265, 2048, 255, 256,
                                         257]))]
    # MHA: musicgen's decode on both bodies, and qwen1.5-32b's heads
    cases += [(dt, rows, dict(MG_DECODE, lengths=lengths))
              for dt in (torch.float32, torch.bfloat16)
              for rows in ("identity", "group_perm", "partial")]
    cases += [(dt, "group_perm", dict(B=2, H=40, KvE=40, dh=128,
                                      lengths=[MAIN_T, 700]))
              for dt in (torch.float32, torch.bfloat16)]
    worst = worst_rel = 0.0
    bad = []
    for i, (dt, rows, kw) in enumerate(cases):
        q, k, v, lens, r = decode_inputs(dt, rows=rows, seed=i, **kw)
        out = decode_attention_resident(q, k, v, lens, r)
        torch.cuda.synchronize()
        want = decode_attention_resident_plain(q, k, v, lens, r)
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out, want)
        ok = torch.allclose(out.float(), want.float(), **TOLS[dt]) \
            and rel <= DECODE_ROW_REL[dt]
        log(f"kernel vs plain {str(dt)[6:]:8s} rows={rows:10s} "
            f"dh={q.shape[2]:3d} KvE={k.shape[1]} T={k.shape[2]:4d} "
            f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e} (limit "
            f"{DECODE_ROW_REL[dt]:.0e})")
        if not (ok and torch.isfinite(out).all().item()):
            bad.append(f"{str(dt)[6:]} {rows} {tuple(k.shape)}")
        if dt == torch.bfloat16:
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        del q, k, v, out, want
    # every case is logged before the first disagreement fails the phase
    check(not bad, f"kernel disagrees with its plain version: {bad}")

    # timing at the main paths' shapes and dtype (bf16, all 32 rows), on
    # input copies together larger than the 50 MB L2 so every call reads
    # cold (dense: 4 x 32 MB of K/V; glm4: 3 x 68 MB)
    def timed(lens_of, copies=4, plain_reps=(20, 50), **shape):
        sets = [decode_inputs(torch.bfloat16, seed=s, **shape)
                for s in range(copies)]
        sets = [(q, k, v, lens_of(lens), r) for q, k, v, lens, r in sets]
        kern = cuda_ms([lambda a=a: decode_attention_resident(*a)
                        for a in sets])
        plain = cuda_ms([lambda a=a: decode_attention_resident_plain(*a)
                         for a in sets], *plain_reps)
        lib = cuda_ms([sdpa_decode(*a) for a in sets])
        q, k, _, lens, r = sets[0]
        return (kern, plain, lib) + decode_bound_ms(q, lens, r, *k.shape[1:3])

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    shapes = {}
    for label, lens_of, shape in (
            ("dense", lambda lens: lens, dict(lengths=lengths)),
            (f"dense full {MAIN_T}", lambda lens: torch.full_like(lens,
                                                                  MAIN_T),
             dict(lengths=lengths)),
            ("glm4", lambda lens: lens,
             dict(GLM_DECODE, lengths=GLM_DECODE_LENGTHS, copies=3,
                  plain_reps=(2, 5))),
            ("musicgen", lambda lens: lens, dict(MG_DECODE,
                                                 lengths=lengths))):
        t = timed(lens_of, **shape)
        shapes[label] = dict(zip(keys, t))
        B, H, KvE, dh, T = (shape.get(n, d) for n, d in (
            ("B", MAIN_B), ("H", MAIN_H), ("KvE", MAIN_KVE), ("dh", MAIN_DH),
            ("T", MAIN_T)))
        log(f"decode_attention_resident bf16 {label} B={B} H={H} KvE={KvE} "
            f"dh={dh} T={T} lengths={shape['lengths']}: kernel "
            f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, sdpa {t[2]:.4f} ms, bound "
            f"{t[3]:.4f} ms ({t[4]})")
        release()
    return {"name": "decode_attention_resident", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:152",
            "max_abs_err": worst, "max_rel_err": worst_rel,
            **shapes["dense"], "shapes": shapes}


def _pool(caches, rng, P, lengths):
    """The model-layout (B, T, KvE, dh) ``caches`` as page stores
    (n_pages, P, KvE, dh) whose pages sit at one random permutation of the
    pool, and the (B, np) page map with -1 -> 0 entries past each row's
    live pages (as the model passes it)."""
    B, T = caches[0].shape[:2]
    dev = caches[0].device
    n_log = T // P
    perm = torch.as_tensor(rng.permutation(B * n_log).reshape(B, n_log),
                           device=dev)
    pools = []
    for c in caches:
        pool = torch.empty((B * n_log, P) + c.shape[2:], dtype=c.dtype,
                           device=dev)
        pool[perm.reshape(-1)] = c.reshape((B * n_log, P) + c.shape[2:])
        pools.append(pool)
    live = (lengths.clamp(0, T) + P - 1) // P
    live_page = torch.arange(n_log, device=dev)[None] < live[:, None]
    return pools, torch.where(live_page, perm, 0).to(torch.int32)


def kv_inputs(kind, dtype, *, rows="identity", lengths=None, seed=0, P=64):
    """Kernel-layout arguments of the ``kind`` kernel ("dense", "int8",
    "paged", "int8_paged") at the main path's shapes: K/V and scales are
    transposed views of the model's (B, T, KvE, dh) cache or (n_pages, P,
    KvE, dh) page store; int8 values and scales come from the port's
    ``_q8``."""
    from repro_torch.models.layers import _q8
    q, k, v, lens, r = decode_inputs(dtype, rows=rows, lengths=lengths,
                                     seed=seed)
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)       # (B, T, KvE, dh)
    if "paged" in kind:
        (kc, vc), pmap = _pool((kc, vc), np.random.default_rng(seed), P,
                               lens)
    if "int8" in kind:
        (kc, ks), (vc, vs) = _q8(kc), _q8(vc)
        ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
        if "paged" in kind:
            ks, vs = ks[..., None], vs[..., None]
        kv = (kc.transpose(1, 2), ks, vc.transpose(1, 2), vs)
    else:
        kv = (kc.transpose(1, 2), vc.transpose(1, 2))
    return (q,) + kv + (lens,) + ((pmap,) if "paged" in kind else ()) + (r,)


NEW_KERNELS = {   # kind -> (wrapper name, TPU kernel it replaces)
    "int8": ("decode_attention_int8_resident",
             "src/repro/kernels/decode_attention.py:213"),
    "paged": ("decode_attention_paged_resident",
              "src/repro/kernels/decode_attention.py:286"),
    "int8_paged": ("decode_attention_int8_paged_resident",
                   "src/repro/kernels/decode_attention.py:354"),
}


def kv_bound_ms(kind, args):
    """:func:`decode_bound_ms` of the ``kind`` kernel's arguments: int8
    reads dh bytes plus a float32 scale per (token, head); a paged cache
    reads the same bytes as the linear one."""
    q, lens, rows = args[0], args[-3 if "paged" in kind else -2], args[-1]
    KvE = args[1].shape[1]
    T = args[-2].shape[1] * args[1].shape[2] if "paged" in kind \
        else args[1].shape[2]
    return decode_bound_ms(q, lens, rows, KvE, T,
                           q.shape[2] + 4 if "int8" in kind else None)


def phase_new_kernels_vs_plain():
    """The int8, paged and int8-paged kernels against their plain versions
    at the main path's shapes (bf16 and f32; identity, group-permuted and
    partial rows; lengths 0, 1, T-1, T, T+1; paged at P = 64 and 8 over a
    scrambled pool), then their times at the main path's bf16 shapes.
    Each case is held to TOLS and to DECODE_ROW_REL per (b, resident row);
    every case of every kernel is logged before a disagreement fails the
    phase (a kernel that disagrees is not timed)."""
    from repro_torch.kernels import decode_attention as da
    lengths = [0, 1, MAIN_T - 1, MAIN_T, MAIN_T + 1, 37, 512, 700]
    records, failed = [], []
    for kind, (name, replaces) in NEW_KERNELS.items():
        kern = getattr(da, name)
        plain = getattr(da, name + "_plain")
        worst = worst_rel = 0.0
        bad = []
        for i, (dt, rows, P) in enumerate(
                (dt, rows, P) for dt in (torch.float32, torch.bfloat16)
                for rows in ("identity", "group_perm", "partial")
                for P in ((64, 8) if "paged" in kind else (None,))):
            args = kv_inputs(kind, dt, rows=rows, lengths=lengths, seed=i,
                             P=P or 64)
            out = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = (out.float() - want.float()).abs().max().item()
            rel = row_rel_err(out, want)
            ok = torch.allclose(out.float(), want.float(), **TOLS[dt]) \
                and rel <= DECODE_ROW_REL[dt]
            log(f"{name} vs plain {str(dt)[6:]:8s} rows={rows:10s}"
                f"{f' P={P}' if P else ''} max_abs_err={err:.3e} "
                f"max_row_rel_err={rel:.3e} (limit "
                f"{DECODE_ROW_REL[dt]:.0e})")
            if not (ok and torch.isfinite(out).all().item()
                    and not out[0].any().item()):
                bad.append(f"{str(dt)[6:]} {rows} P={P}")
            worst = max(worst, err)
            if dt == torch.bfloat16:
                worst_rel = max(worst_rel, rel)
        if bad:
            failed.append(f"{name} disagrees with its plain version: {bad}")
            continue
        # timing at the main path's bf16 shapes (P = 64), on input copies
        # together larger than the 50 MB L2 so every call reads cold
        sets = [kv_inputs(kind, torch.bfloat16, lengths=lengths, seed=s)
                for s in range(8)]
        ms = cuda_ms([lambda a=a: kern(*a) for a in sets])
        plain_ms = cuda_ms([lambda a=a: plain(*a) for a in sets])
        bound, bound_by = kv_bound_ms(kind, sets[0])
        log(f"{name} bf16 B={MAIN_B} H={MAIN_H} KvE={MAIN_KVE} "
            f"dh={MAIN_DH} T={MAIN_T}{' P=64' if 'paged' in kind else ''} "
            f"lengths={lengths}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bound:.4f} ms ({bound_by})")
        log(f"  library_ms null: no single PyTorch call reads "
            f"{'a page table' if 'paged' in kind else ''}"
            f"{' and ' if kind == 'int8_paged' else ''}"
            f"{'int8 K/V with scales' if 'int8' in kind else ''}")
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": replaces, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "max_rel_err": worst_rel})
    check(not failed, "; ".join(failed))
    return records


def phase_paged_equals_dense():
    """Paged equals dense bit for bit at the kernel level: a pool holding
    the main path's cache (fp, and int8 with its scales) in scrambled pages
    of 64, np * P == T, gives the linear kernel's output exactly, at f32
    and bf16, for identity and group-permuted rows: both run the split
    body with one split, and only addressing differs between them."""
    from repro_torch.kernels import decode_attention as da
    names = {"dense": "decode_attention_resident",
             **{kind: name for kind, (name, _) in NEW_KERNELS.items()}}
    lengths = [0, 1, MAIN_T - 1, MAIN_T, MAIN_T + 1, 37, 512, 700]
    bad = []
    for kind, linear in (("paged", "dense"), ("int8_paged", "int8")):
        for i, (dt, rows) in enumerate(
                (dt, rows) for dt in (torch.float32, torch.bfloat16)
                for rows in ("identity", "group_perm")):
            out, want = (getattr(da, names[k])(*kv_inputs(
                k, dt, rows=rows, lengths=lengths, seed=i))
                for k in (kind, linear))
            torch.cuda.synchronize()
            same = torch.equal(out, want)
            log(f"{names[kind]} == {names[linear]} {str(dt)[6:]:8s} "
                f"rows={rows:10s} P=64: "
                f"{'bit for bit' if same else 'DIFFER'} (max abs difference "
                f"{(out.float() - want.float()).abs().max():.3e})")
            if not same:
                bad.append(f"{names[kind]} {str(dt)[6:]} {rows}")
    check(not bad, f"paged kernels differ from the linear ones: {bad}")


def ring_slot_pos(window: int, n_written: int) -> np.ndarray:
    """A ring's slot positions after positions 0 .. n_written - 1 were
    written, slot ``t % window`` taking position t; never-written slots
    hold -2**30."""
    pos = np.full(window, -2 ** 30, np.int64)
    for t in range(max(0, n_written - window), n_written):
        pos[t % window] = t
    return pos


def ring_inputs(dtype, *, n_written, lengths, rows="identity", seed=0):
    """Kernel-layout arguments of the ring kernel at the mixtral path's
    shapes (B 4, H 32, KvE 8, dh 128, window 4096): K/V are transposed
    views of a (B, window, KvE, dh) ring as the model passes them."""
    q, k, v, lens, r = decode_inputs(
        dtype, B=RING_B, T=RING_W, rows=rows, lengths=lengths, seed=seed)
    slot_pos = torch.as_tensor(ring_slot_pos(RING_W, n_written),
                               dtype=torch.int32, device="cuda")
    return q, k, v, lens, slot_pos, r


def ring_valid(lens, slot_pos):
    """(B, window) validity of each ring slot for each row."""
    n, pos = lens.long()[:, None], slot_pos.long()[None, :]
    return (pos < n) & (pos >= n - RING_W)


def phase_ring_vs_plain():
    """The ring kernel against its plain version at the mixtral path's
    shapes (bf16 and f32): a wrapped ring (lengths 4097-8192), a partly
    filled one with empty slots (lengths 1, 37, 4095, 4096 over 3000
    written positions) and resident rows under a group permutation, each
    held to TOLS and to RING_ROW_REL per (b, resident row); then its time
    on the main path's bf16 inputs (a full wrapped ring)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_ring_resident as kern,
        decode_attention_ring_resident_plain as plain)
    cases = [("wrapped", 8192, [8192, 8000, 6001, 4097], "identity"),
             ("partly_filled", 3000, [1, 37, 4095, 4096], "identity"),
             ("permuted", 8192, [8192, 5000, 4500, 4097], "group_perm")]
    worst = worst_rel = 0.0
    bad = []
    for i, (dt, (label, n, lengths, rows)) in enumerate(
            (dt, c) for dt in (torch.float32, torch.bfloat16)
            for c in cases):
        args = ring_inputs(dt, n_written=n, lengths=lengths, rows=rows,
                           seed=i)
        out = kern(*args, window=RING_W)
        torch.cuda.synchronize()
        want = plain(*args, window=RING_W)
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out, want)
        ok = torch.allclose(out.float(), want.float(), **TOLS[dt]) \
            and rel <= RING_ROW_REL[dt]
        log(f"decode_attention_ring_resident vs plain {str(dt)[6:]:8s} "
            f"{label:13s} rows={rows:10s} max_abs_err={err:.3e} "
            f"max_row_rel_err={rel:.3e} (limit {RING_ROW_REL[dt]:.0e})")
        if not (ok and torch.isfinite(out).all().item()):
            bad.append(f"{str(dt)[6:]} {label}")
        if dt == torch.bfloat16:
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
    # every case is logged before the first disagreement fails the phase
    check(not bad, f"ring kernel disagrees with its plain version: {bad}")
    # the main path's decode: every row at one length past the window, all
    # slots valid; 4 input copies (4 x 67 MB of K/V) so every call reads
    # cold
    n = RING_PROMPT + RING_NEW
    sets = [ring_inputs(torch.bfloat16, n_written=n, lengths=[n] * RING_B,
                        seed=s) for s in range(4)]
    ms = cuda_ms([lambda a=a: kern(*a, window=RING_W) for a in sets])
    plain_ms = cuda_ms([lambda a=a: plain(*a, window=RING_W) for a in sets])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_calls = []
    for q, k, v, lens, slot_pos, r in sets:
        mask = ring_valid(lens, slot_pos)[:, None, None, :]
        qs = q.index_select(1, r.long())[:, :, None, :]
        lib_calls.append(lambda qs=qs, k=k, v=v, mask=mask: sdpa(
            qs, k, v, attn_mask=mask, enable_gqa=True))
    lib = cuda_ms(lib_calls)
    q, k, _, lens, slot_pos, r = sets[0]
    KvE = k.shape[1]
    # bytes: the valid K/V slots and the slot positions, each read once
    bound, bound_by = decode_bound_ms(
        q, lens, r, KvE, RING_W, valid=int(ring_valid(lens, slot_pos).sum()),
        extra_bytes=4 * RING_W)
    log(f"decode_attention_ring_resident bf16 B={RING_B} H={q.shape[1]} "
        f"KvE={KvE} dh={q.shape[2]} window={RING_W} lengths={n}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa with mask "
        f"{lib:.4f} ms, bound {bound:.4f} ms ({bound_by})")
    return {"name": "decode_attention_ring_resident", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:456",
            "max_abs_err": worst, "max_rel_err": worst_rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib}


# ---------------------------------------------------------------- phase 3
def traffic(n_requests: int, vocab: int, length=None, lo=32, hi=512):
    """Prompts from ``default_rng(0)``: lengths ``lo``-``hi``, or all
    ``length`` tokens long."""
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, n_requests) if length is None \
        else [length] * n_requests
    return [rng.integers(0, vocab, int(n)) for n in lens]


def time_prefill(eng):
    """Wrap the engine model's prefill entry points (bucketed, paged chunk,
    lock-step) in a host clock that starts and ends with a device sync;
    returns {"s": seconds so far, "calls": count}."""
    spent = {"s": 0.0, "calls": 0}
    for name in ("prefill_bucketed", "prefill_paged", "prefill"):
        inner = getattr(eng.model, name, None)
        if inner is None:
            continue

        def timed(*a, inner=inner):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = inner(*a)
            torch.cuda.synchronize()
            spent["s"] += time.monotonic() - t0
            spent["calls"] += 1
            return out

        setattr(eng.model, name, timed)
    return spent


def log_split(eng, wall, prefill):
    """The host-clock split of a main path's wall time."""
    decode_s, interval_s = sum(eng.step_times), sum(eng.interval_times)
    log(f"  host-clock split of {wall:.2f} s: decode steps {decode_s:.2f} s, "
        f"controller intervals {interval_s:.2f} s, prefill "
        f"{prefill['s']:.2f} s ({prefill['calls']} calls), admission, "
        f"sampling and the rest "
        f"{wall - decode_s - interval_s - prefill['s']:.2f} s")


def graph_decode_step(eng):
    """After the drain, the whole batch's decode step captured in a CUDA
    graph and replayed (``cuda_ms``; positions advance to the cache edge,
    so the rows attend their full extent): the device's own time for a
    step, host launches removed.  Logged beside the eager step median
    (``step_times``: launches, then a device sync), whose rest is the time
    the device waits for the host's launches.  The engine's counts are
    read before this runs."""
    tokens = torch.as_tensor(eng._next, device=eng.device)
    graph_ms = cuda_ms([lambda: eng.model.decode_step(eng.params, eng.state,
                                                      tokens)], reps=5, n=20)
    eager_ms = 1e3 * float(np.median(eng.step_times))
    log(f"  decode step as one CUDA graph: {graph_ms:.3f} ms of device work "
        f"against the eager median {eager_ms:.2f} ms (the device idle "
        f"{100 * (1 - graph_ms / eager_ms):.1f} % of an eager step)")


def watch_logits(eng):
    """Wrap the engine model's decode_step: keep the last logits and a
    device-side flag that every step's logits were finite."""
    inner = eng.model.decode_step
    seen = {"finite": torch.ones((), dtype=torch.bool, device=eng.device)}

    def decode_step(params, state, tokens):
        logits, state = inner(params, state, tokens)
        seen["finite"] &= torch.isfinite(logits).all()
        seen["last"] = logits
        return logits, state

    eng.model.decode_step = decode_step
    return seen


def serve(cfg, *, use_kernel, n_requests, max_new, params=None, lam=8,
          **kw):
    """The main path's engine with every request submitted: 8 slots, a
    1024-token cache, λ = 8, four simulated devices; ``kw`` are the
    engine's paged-cache and pipelining arguments."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, n_slots=MAIN_B, max_seq=MAIN_T, lam=lam,
                        seed=0, net=DeviceNetwork.sample(4, seed=1),
                        use_kernel=use_kernel, device="cuda", params=params,
                        **kw)
    for p in traffic(n_requests, cfg.vocab_size):
        eng.submit(p, max_new_tokens=max_new)
    return eng


def drive(eng, straggle_at=16):
    """One scheduler step; at ``straggle_at`` a 500x straggler lands on
    the device holding the most heads."""
    if eng.decode_steps == straggle_at:
        dev = int(eng.controller.head_counts().argmax())
        eng.net.inject_straggler(dev, slowdown=500.0)
    return eng.step()


# The main paths: each cache kind with the kernel that carries its decode.
# The paged pool of 48 pages (64 tokens each) is below the 128 a dense
# 8 x 1024 cache reserves, so admission waits for pages (63 scheduler
# steps on this traffic: the retire times are fixed by max_new_tokens).
PATHS = {
    "dense": ("decode_attention_resident", {}, {}),
    "paged": ("decode_attention_paged_resident", {},
              dict(paged=True, page_size=64, kv_pages=48)),
    "int8": ("decode_attention_int8_resident", {"kv_quant": True}, {}),
    "int8_paged": ("decode_attention_int8_paged_resident",
                   {"kv_quant": True},
                   dict(paged=True, page_size=64, kv_pages=48)),
}


def phase_main_path(path="dense"):
    """Serve 16 requests x 64 tokens on the ``path`` cache through its
    kernels; returns the decode kernel's and the flash kernel's launches
    in the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention
    name, over, kw = PATHS[path]
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS, **over)
    eng = serve(cfg, use_kernel=True, n_requests=16, max_new=64, **kw)
    seen = watch_logits(eng)
    prefill = time_prefill(eng)
    torch.cuda.synchronize()
    for kernel, _, _ in PATHS.values():
        getattr(da, kernel).launches = 0
    flash_attention.launches = 0
    t0 = time.monotonic()
    while drive(eng):
        pass
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {kernel: getattr(da, kernel).launches
                for kernel, _, _ in PATHS.values()}
    flash = flash_attention.launches
    tokens = sum(len(r.out_tokens) for r in eng.finished)
    applied = [e for e in eng.migration_log
               if e["applied"] and e["n_migrations"]]
    log(f"main path {path} bf16 llama3-8b x{N_LAYERS} layers: "
        f"{len(eng.finished)} requests, {tokens} tokens, "
        f"{eng.decode_steps} decode steps in {wall:.2f} s "
        f"({tokens / wall:.1f} tok/s); decode step median "
        f"{1e3 * float(np.median(eng.step_times)):.2f} ms; "
        f"{len(eng.interval_times)} controller intervals, mean "
        f"{1e3 * float(np.mean(eng.interval_times)):.1f} ms; "
        f"{sum(e['n_migrations'] for e in eng.migration_log)} head "
        f"migrations in {len(applied)} applied intervals; kernel launches "
        f"{launches}, flash_attention {flash}")
    log_split(eng, wall, prefill)
    check(len(eng.finished) == 16 and all(len(r.out_tokens) == 64
                                          for r in eng.finished),
          f"{path}: not every request finished with its 64 tokens")
    check(bool(applied), f"{path}: no interval applied a migration")
    check(launches[name] == eng.decode_steps * cfg.n_layers,
          f"{path}: kernel launches {launches[name]} != decode steps "
          f"{eng.decode_steps} x {cfg.n_layers} layers")
    check(not any(n for k, n in launches.items() if k != name),
          f"{path}: another path's kernel launched: {launches}")
    check(flash == FLASH_LAUNCHES[path],
          f"{path}: flash_attention launches {flash} != "
          f"{FLASH_LAUNCHES[path]}")
    check(bool(seen["finite"].item()),
          f"{path}: non-finite logits on the main path")
    if eng.paged:
        eng.allocator.check_invariants()
        log(f"  paged pool {eng.kv_pages} pages of {eng.page_size}: "
            f"admission waited {eng.page_waits} scheduler steps; "
            f"{eng.allocator.live_pages} pages live after drain")
        check(eng.allocator.live_pages == 0, f"{path}: pages live after "
              f"drain")
        check(eng.page_waits > 0, f"{path}: admission never waited for "
              f"pages")
    if path == "dense":
        graph_decode_step(eng)
    return launches[name], flash


# ---------------------------------------------------------------- phase 4
# f32 stream checks: (label, engine A, engine B, whether the migration logs
# must be equal).  Each engine is (config overrides, use_kernel, engine
# kwargs).  Paged runs use the default pool (the full dense reservation),
# so their admission — and so every decode batch — is the dense engine's.
# A paged engine's controller sees page-rounded occupancy and prices
# migrations from live pages (the reference's design), so its plans may
# differ from a dense engine's; that pair holds the streams only, as the
# reference's own paged-vs-dense test does.
PAIRS = [
    ("dense kernel vs plain", ({}, True, {}), ({}, False, {}), True),
    ("paged kernel vs plain", ({}, True, {"paged": True}),
     ({}, False, {"paged": True}), True),
    ("paged kernel vs dense kernel", ({}, True, {"paged": True}),
     ({}, True, {}), False),
    ("int8 kernel vs plain", ({"kv_quant": True}, True, {}),
     ({"kv_quant": True}, False, {}), True),
    ("int8 paged kernel vs plain", ({"kv_quant": True}, True, {"paged": True}),
     ({"kv_quant": True}, False, {"paged": True}), True),
]


def phase_stream_equality():
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    base = get_config("llama3-8b").with_overrides(
        n_layers=N_LAYERS, dtype="float32", param_dtype="float32")
    params = build_model(base, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    keys = ("step", "n_migrations", "mig_bytes", "applied")
    for label, *sides, same_plans in PAIRS:
        engines = [serve(base.with_overrides(**over), use_kernel=uk,
                         n_requests=8, max_new=32, params=params, **kw)
                   for over, uk, kw in sides]
        seen = [watch_logits(e) for e in engines]
        worst = 0.0
        while True:
            more = [drive(e) for e in engines]
            check(more[0] == more[1], f"{label}: the two engines stopped "
                  f"at different steps")
            if not more[0]:
                break
            active = engines[0]._active()
            diff = (seen[0]["last"][active]
                    - seen[1]["last"][active]).abs().max().item() \
                if active else 0.0
            worst = max(worst, diff)
        streams = [{r.rid: r.out_tokens for r in e.finished} for e in engines]
        logs = [[tuple(m[k] for k in keys) for m in e.migration_log]
                for e in engines]
        migrations = [sum(m[1] for m in lg if m[3]) for lg in logs]
        log(f"f32 streams {label}: {len(streams[0])} requests, max "
            f"per-step logit difference {worst:.3e}, applied migrations "
            f"{migrations[0]} and {migrations[1]}, logs "
            f"{'equal' if logs[0] == logs[1] else 'differ'}")
        check(len(streams[0]) == 8 and streams[0] == streams[1],
              f"{label}: greedy streams differ")
        check(logs[0] == logs[1] or not same_plans,
              f"{label}: migration logs differ")
        check(min(migrations) > 0, f"{label}: no migration was applied")
        check(all(bool(s["finite"].item()) for s in seen),
              f"{label}: non-finite logits")
        del engines, seen
        torch.cuda.empty_cache()


# ------------------------------------------------------ the mixtral path
def expert_straggler(eng, at: int):
    """A token hook that lands a 500x straggler on the device holding the
    most expert blocks, once, when the scheduler has run ``at`` decode
    steps (and that step's interval)."""
    fired = []

    def sink(req, tok, done):
        if not fired and eng.decode_steps == at:
            counts = np.zeros(eng.net.n_devices)
            for block in eng.controller.blocks:
                if block.kind == "expert":
                    counts[int(eng.controller.place[block.index])] += 1
            eng.net.inject_straggler(int(counts.argmax()), slowdown=500.0)
            fired.append(at)

    eng.token_sink = sink
    return fired


def mixtral_engine(cfg, *, use_kernel, n_requests, max_new, seed=0,
                   params=None, n_slots=RING_B):
    """``make_engine(mode="auto")`` for ``cfg`` over an 8192-token extent
    (a ring of the 4096-token window), λ = 8, four simulated devices, with
    ``n_requests`` 4096-token prompts from ``default_rng(seed)``."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import make_engine
    eng = make_engine(cfg, mode="auto", n_slots=n_slots, max_seq=8192,
                      lam=8, seed=0, net=DeviceNetwork.sample(4, seed=1),
                      use_kernel=use_kernel, params=params, device="cuda")
    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        eng.submit(rng.integers(0, cfg.vocab_size, RING_PROMPT),
                   max_new_tokens=max_new)
    return eng


def phase_mixtral_ring():
    """Serve 8 requests (4096-token prompts, 64 new tokens each) on the
    full-width 4-layer mixtral through ``make_engine(mode="auto")``, which
    must pick the wave scheduler over the ring cache; the ring wraps from
    the first decode step, and a straggler at step 16 on the device with
    the most expert blocks makes the controller move heads and experts.
    Returns the ring kernel's launches in the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving.engine import WaveServingEngine
    cfg = get_config("mixtral-8x7b").with_overrides(n_layers=N_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = mixtral_engine(cfg, use_kernel=True, n_requests=8,
                         max_new=RING_NEW)
    check(isinstance(eng, WaveServingEngine),
          f"make_engine picked {type(eng).__name__} for a ring cache")
    weight_gb = sum(t.numel() * t.element_size() for t in
                    _leaves(eng.params)) / 1e9
    fired = expert_straggler(eng, 16)
    seen = watch_logits(eng)
    prefill = time_prefill(eng)
    kernels = [k for k, _, _ in PATHS.values()] + [
        "decode_attention_ring_resident"]
    torch.cuda.synchronize()
    for kernel in kernels:
        getattr(da, kernel).launches = 0
    flash_attention.launches = 0
    t0 = time.monotonic()
    eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: getattr(da, k).launches for k in kernels}
    flash = flash_attention.launches
    ring = launches["decode_attention_ring_resident"]
    tokens = sum(len(r.out_tokens) for r in eng.finished)
    heads = [e for e in eng.migration_log if e["applied"]
             and e["n_migrations"]]
    experts = [e for e in eng.migration_log if e["expert_applied"]
               and e["n_expert_migrations"]]
    n_exp = sum(e["n_expert_migrations"] for e in experts)
    exp_bytes = sum(e["expert_mig_bytes"] for e in experts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hd = eng.model.hd
    ring_gb = 2 * N_LAYERS * RING_B * RING_W * hd.KvE * hd.dh * 2 / 1e9
    log(f"main path mixtral ring (make_engine auto -> "
        f"{type(eng).__name__}) bf16 mixtral-8x7b x{N_LAYERS} layers: "
        f"{len(eng.finished)} requests, {tokens} tokens, "
        f"{eng.decode_steps} decode steps in {wall:.2f} s "
        f"({tokens / wall:.1f} tok/s); decode step median "
        f"{1e3 * float(np.median(eng.step_times)):.2f} ms; "
        f"{len(eng.interval_times)} controller intervals, mean "
        f"{1e3 * float(np.mean(eng.interval_times)):.1f} ms; straggler at "
        f"step {fired}; kernel launches {launches}, flash_attention "
        f"{flash}")
    log_split(eng, wall, prefill)
    log(f"  applied: {sum(e['n_migrations'] for e in heads)} head "
        f"migrations ({sum(e['mig_bytes'] for e in heads) / 1e6:.1f} MB) in "
        f"{len(heads)} intervals, {n_exp} expert migrations "
        f"({exp_bytes / 1e6:.1f} MB, "
        f"{exp_bytes / max(n_exp, 1) / 1e6:.1f} MB each) in {len(experts)} "
        f"intervals")
    log(f"  memory: weights {weight_gb:.2f} GB, ring K/V {ring_gb:.2f} GB, "
        f"peak allocated {peak_gb:.2f} GB")
    check(len(eng.finished) == 8 and all(len(r.out_tokens) == RING_NEW
                                         for r in eng.finished),
          "mixtral: not every request finished with its tokens")
    check(ring == eng.decode_steps * cfg.n_layers,
          f"mixtral: ring kernel launches {ring} != decode steps "
          f"{eng.decode_steps} x {cfg.n_layers} layers")
    check(not any(n for k, n in launches.items()
                  if k != "decode_attention_ring_resident"),
          f"mixtral: another kernel launched: {launches}")
    check(flash == FLASH_LAUNCHES["mixtral"],
          f"mixtral: flash_attention launches {flash} != "
          f"{FLASH_LAUNCHES['mixtral']} (2 waves x {N_LAYERS} layers)")
    check(bool(heads), "mixtral: no interval applied a head migration")
    check(bool(experts), "mixtral: no interval applied an expert migration")
    check(bool(seen["finite"].item()), "mixtral: non-finite logits")
    return ring, flash


def release():
    """Free what the last phase left: its engines can sit in reference
    cycles (a token hook that closes over its engine), which only the
    collector frees, and the peak of the next phase must not count them."""
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_mixtral_stream_pair():
    """float32, 2 layers: the mixtral ring path with and without the ring
    kernel, from the same weights and a straggler at step 8, must stream
    the same greedy tokens with the same migration logs."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("mixtral-8x7b").with_overrides(
        n_layers=2, dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    keys = ("step", "n_migrations", "mig_bytes", "n_expert_migrations",
            "expert_mig_bytes", "applied", "expert_applied")
    runs = []
    for use_kernel in (True, False):
        eng = mixtral_engine(cfg, use_kernel=use_kernel, n_requests=4,
                             max_new=32, seed=1, params=params, n_slots=2)
        expert_straggler(eng, 8)
        logits, inner = [], eng.model.decode_step

        def decode_step(p, state, tokens, inner=inner, logits=logits):
            out, state = inner(p, state, tokens)
            logits.append(out.clone())
            return out, state

        eng.model.decode_step = decode_step
        eng.run()
        runs.append(({r.rid: r.out_tokens for r in eng.finished},
                     [tuple(m[k] for k in keys) for m in eng.migration_log],
                     logits))
        del eng
        release()
    (s0, l0, g0), (s1, l1, g1) = runs
    worst = max((a - b).abs().max().item() for a, b in zip(g0, g1))
    moved = sum(m[1] * m[5] + m[3] * m[6] for m in l0)
    log(f"f32 streams mixtral ring kernel vs plain (2 layers): {len(s0)} "
        f"requests, max per-step logit difference {worst:.3e}, applied "
        f"migrations {moved} (head + expert), logs "
        f"{'equal' if l0 == l1 else 'differ'}")
    check(len(s0) == 4 and s0 == s1, "mixtral: greedy streams differ")
    check(l0 == l1, "mixtral: migration logs differ")
    check(moved > 0, "mixtral: no migration was applied")
    check(all(torch.isfinite(g).all().item() for g in g0 + g1),
          "mixtral: non-finite logits")


# ------------------------------------------------------- the rwkv6 path
def extreme_decays(u: torch.Tensor, smooth: torch.Tensor) -> torch.Tensor:
    """Decays as the rwkv6 path meets them — one full-width rwkv6-7b layer
    over 256 tokens, adapters seeded as ``nonzero_adapters`` seeds them,
    gave exact 0.0, values below 1e-30, exact 1.0 and a third above 0.999
    — from a uniform draw ``u`` in [0, 1): 0.0 where u < 0.03, 10^-30 to
    10^-44 (below 1e-38 a float32 denormal) where u < 0.06, 1.0 where
    u < 0.26, 1 - 10^-3 x (0, 1] where u < 0.66, else ``smooth``."""
    f = u.double()
    tiny = torch.pow(10.0, -30.0 - 14.0 * (f - 0.03) / 0.03)
    near = 1.0 - 1e-3 * (0.66 - f) / 0.4
    w = torch.where(f < 0.66, near, smooth.double())
    w = torch.where(f < 0.26, 1.0, w)
    w = torch.where(f < 0.06, tiny, w)
    return torch.where(f < 0.03, 0.0, w).float()


def rwkv6_inputs(dtype, *, S, B=RWKV_B, H=RWKV_H, dh=RWKV_DH, seed=0,
                 decays="smooth"):
    """Kernel-layout arguments of the WKV6 kernel: r/k/v in ``dtype`` and
    w float32 as transposed views of (B, S, H, dh) activations (the
    model's layout), u (H, dh) in ``dtype`` (the param dtype) and a nonzero
    float32 starting state, all from ``default_rng(seed)``.  ``decays``:
    "smooth" draws w in (0.45, 0.95); "extreme" mixes in the path's
    extremes (``extreme_decays``)."""
    rng = np.random.default_rng(seed)
    act = torch.from_numpy(rng.standard_normal((4, B, S, H, dh),
                                               np.float32)).to("cuda")
    act *= 0.5
    r, k, v = (act[i].to(dtype).transpose(1, 2) for i in range(3))
    w = 0.45 + 0.5 * torch.sigmoid(act[3])
    if decays == "extreme":
        w = extreme_decays(torch.from_numpy(
            rng.random((B, S, H, dh), np.float32)).to("cuda"), w)
    w = w.transpose(1, 2)
    del act
    u = torch.from_numpy(0.5 * rng.standard_normal((H, dh), np.float32)
                         ).to("cuda", dtype)
    s0 = torch.from_numpy(0.1 * rng.standard_normal((B, H, dh, dh),
                                                    np.float32)).to("cuda")
    return r, k, v, w, u, s0


def rwkv6_bound_ms(r, w, u, state):
    """Least time for the recurrence on these inputs: r/k/v, w and u read
    once, y written once in float32, the state read and written once;
    operations as the body that runs them does them.  Per-step body (S <
    RWKV_CHUNK): 5 dh^2 + 3 dh float32 flops per (b, h, t) on the CUDA
    cores.  Chunked body, per (b, h) and chunk of C steps: the products
    2 C dh^2 (inter-chunk), 2 C^2 dh (A V) and 2 C dh^2 (state) on the
    tensor cores in three TF32 passes, a third of the TF32 rate; A's
    C (C - 1) / 2 pairs and C bonus entries, 3 flops per channel, and the
    2 C dh decay factors on the CUDA cores; the slower unit bounds."""
    B, H, S, dh = r.shape
    nbytes = 3 * r.numel() * r.element_size() + w.numel() * 4 \
        + r.numel() * 4 + u.numel() * u.element_size() \
        + 2 * state.numel() * 4
    if S < RWKV_CHUNK:
        t_ops = B * H * S * (5 * dh * dh + 3 * dh) \
            / PEAK_FLOPS[torch.float32]
    else:
        C, n_chunks = RWKV_CHUNK, -(-S // RWKV_CHUNK)
        mma = n_chunks * (4 * C * dh * dh + 2 * C * C * dh)
        core = n_chunks * (3 * dh * C * (C + 1) // 2 + 2 * C * dh)
        t_ops = B * H * max(mma / (PEAK_TF32 / 3),
                            core / PEAK_FLOPS[torch.float32])
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rwkv6_cases():
    """The WKV6 kernel against its plain version at the rwkv6 path's
    widths (B 8, H 64, dh 64) in f32 and bf16, with a nonzero u and
    starting state: the per-step body at S 1 (decode) and 15, the chunked
    body at S 16, 17 (a ragged chunk) and 1024 (prefill), each with smooth
    decays and with the path's extremes (``extreme_decays``); for S > 1
    two chained calls writing the state in place (a per-step and a chunked
    call at S 17) must equal one.  Each case is held to RWKV_TOL and must
    be finite; every case is logged.  Returns the largest error and the
    cases that failed."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked as kern
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_plain as plain
    worst, bad = 0.0, []
    cases = [(dt, S, decays) for decays in ("smooth", "extreme")
             for dt in (torch.float32, torch.bfloat16)
             for S in (1, RWKV_CHUNK - 1, RWKV_CHUNK, RWKV_CHUNK + 1,
                       RWKV_PROMPT)]
    for i, (dt, S, decays) in enumerate(cases):
        args = rwkv6_inputs(dt, S=S, seed=i, decays=decays)
        y, s = kern(*args)
        torch.cuda.synchronize()
        want_y, want_s = plain(*args)
        err = max((y - want_y).abs().max().item(),
                  (s - want_s).abs().max().item())
        ok = torch.allclose(y, want_y, **RWKV_TOL) \
            and torch.allclose(s, want_s, **RWKV_TOL) \
            and torch.isfinite(y).all().item() \
            and torch.isfinite(s).all().item()
        checks = f"y and final state max_abs_err={err:.3e}"
        if S > 1:
            # the state carry: two calls, the state written over itself
            r, k, v, w, u, s0 = args
            state, half = s0.clone(), max(1, S // 2 - 7)
            ys = [kern(r[:, :, a:b], k[:, :, a:b], v[:, :, a:b],
                       w[:, :, a:b], u, state, out_state=state)[0]
                  for a, b in ((0, half), (half, S))]
            torch.cuda.synchronize()
            chain = max((torch.cat(ys, dim=2) - want_y).abs().max().item(),
                        (state - want_s).abs().max().item())
            ok = ok and torch.allclose(torch.cat(ys, dim=2), want_y,
                                       **RWKV_TOL) \
                and torch.allclose(state, want_s, **RWKV_TOL)
            checks += f", two chained calls max_abs_err={chain:.3e}"
            err = max(err, chain)
        log(f"rwkv6_chunked vs plain {str(dt)[6:]:8s} B={RWKV_B} "
            f"H={RWKV_H} S={S:4d} dh={RWKV_DH} {decays:7s} decays: "
            f"{checks}")
        if not ok:
            bad.append(f"{str(dt)[6:]} S={S} {decays}")
        worst = max(worst, err)
        del args
    return worst, bad


def rwkv6_times(plain_too=True):
    """The WKV6 kernel's times at the decode (S 1) and the prefill shape
    (S 1024), bf16 as on the main path, beside its plain version's (if
    ``plain_too``) and the bound: {shape label: times}."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked as kern
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_plain as plain
    shapes = {}
    # eight decode input copies (8 x 8.4 MB of state) so every call reads
    # cold, the state written over itself as on the main path; prefill
    # inputs are 0.3 GB each, one copy, and its plain loop is timed once
    for label, S, copies, plain_reps in (("decode", 1, 8, 20),
                                         ("prefill", RWKV_PROMPT, 1, 1)):
        sets = [rwkv6_inputs(torch.bfloat16, S=S, seed=10 + c)
                for c in range(copies)]
        ms = cuda_ms([lambda a=a: kern(*a, out_state=a[5]) for a in sets])
        plain_ms = cuda_ms([lambda a=a: plain(*a) for a in sets],
                           reps=plain_reps, n=3 if S > 1 else 50) \
            if plain_too else None
        bound, bound_by = rwkv6_bound_ms(sets[0][0], sets[0][3],
                                         sets[0][4], sets[0][5])
        shapes[f"{label} S={S}"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound, "bound_by": bound_by}
        log(f"rwkv6_chunked bf16 {label} B={RWKV_B} H={RWKV_H} S={S} "
            f"dh={RWKV_DH}: kernel {ms:.4f} ms, plain "
            f"{plain_ms or float('nan'):.4f} ms, bound {bound:.4f} ms "
            f"({bound_by})")
        del sets
    return shapes


def phase_rwkv6_vs_plain():
    """``rwkv6_cases`` (every case logged, then any disagreement fails the
    phase), then ``rwkv6_times``: the decode shape's times go into the
    record, both shapes' into its ``shapes``."""
    worst, bad = rwkv6_cases()
    check(not bad, f"rwkv6_chunked disagrees with its plain version: {bad}")
    shapes = rwkv6_times()
    log("  library_ms null: no single PyTorch call computes the WKV6 "
        "recurrence")
    return {"name": "rwkv6_chunked", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6.cu",
            "replaces": "src/repro/kernels/rwkv6_kernel.py:63",
            "max_abs_err": worst, **shapes["decode S=1"], "shapes": shapes}


def nonzero_adapters(params, seed=0):
    """Set ``u`` (0.5 N), ``lora_B`` (0.1 N) and ``lw_B`` (0.5 N) in place
    from a seeded generator: the reference's init leaves them at zero,
    which would silence the bonus term and the data-dependent token shift
    and decay."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, scale in (("u", 0.5), ("lora_B", 0.1), ("lw_B", 0.5)):
        t = params["layers"][name]
        t.copy_(scale * torch.randn(t.shape, generator=gen, device="cuda"))


def head_straggler(eng, at: int):
    """A token hook that lands a 500x straggler on the device holding the
    most heads, once, when the wave scheduler has run ``at`` decode
    steps."""
    fired = []

    def sink(req, tok, done):
        if not fired and eng.decode_steps == at:
            dev = int(np.argmax(eng.controller.head_counts()))
            eng.net.inject_straggler(dev, slowdown=500.0)
            fired.append(at)

    eng.token_sink = sink
    return fired


def rwkv6_engine(cfg, *, use_kernel, n_requests, prompt, max_new,
                 params=None):
    """``make_engine(mode="auto")`` for ``cfg``: 8 slots, λ = 8, four
    simulated devices, ``n_requests`` prompts of ``prompt`` tokens from
    the ``traffic`` helper; random weights from seed 0 unless ``params``
    are given."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import make_engine
    eng = make_engine(cfg, mode="auto", n_slots=RWKV_B,
                      max_seq=prompt + max_new + 8, lam=8, seed=0,
                      net=DeviceNetwork.sample(4, seed=1),
                      use_kernel=use_kernel, params=params, device="cuda")
    for p in traffic(n_requests, cfg.vocab_size, length=prompt):
        eng.submit(p, max_new_tokens=max_new)
    return eng


def phase_rwkv6_path():
    """Serve 16 requests (1024-token prompts, 64 new tokens each, two
    waves of 8) on the full-width 4-layer rwkv6-7b through
    ``make_engine(mode="auto")``, which must pick the wave scheduler;
    prefill and decode run the WKV6 kernel once per layer, and a straggler
    at step 16 makes the controller plan head moves, which the engine logs
    as not applied (the model has no attention heads).  Returns the
    kernel's launches in the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    from repro_torch.serving.engine import WaveServingEngine
    cfg = get_config("rwkv6-7b").with_overrides(n_layers=N_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = rwkv6_engine(cfg, use_kernel=True, n_requests=16,
                       prompt=RWKV_PROMPT, max_new=RWKV_NEW)
    check(isinstance(eng, WaveServingEngine),
          f"make_engine picked {type(eng).__name__} for rwkv6")
    nonzero_adapters(eng.params)
    log("rwkv6 weights: random from seed 0, then u, lora_B and lw_B set "
        "to seeded small random values (the init leaves them at zero)")
    weight_gb = sum(t.numel() * t.element_size() for t in
                    _leaves(eng.params)) / 1e9
    fired = head_straggler(eng, 16)
    seen = watch_logits(eng)
    prefill, inner = [], eng.model.prefill

    def counted_prefill(*a):
        before = rwkv6_chunked.launches
        out = inner(*a)
        prefill.append(rwkv6_chunked.launches - before)
        return out

    eng.model.prefill = counted_prefill
    prefill_time = time_prefill(eng)
    decode_kernels = [k for k, _, _ in PATHS.values()] + [
        "decode_attention_ring_resident"]
    torch.cuda.synchronize()
    for kernel in decode_kernels:
        getattr(da, kernel).launches = 0
    rwkv6_chunked.launches = 0
    flash_attention.launches = 0
    t0 = time.monotonic()
    eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = rwkv6_chunked.launches
    others = {k: getattr(da, k).launches for k in decode_kernels}
    others["flash_attention"] = flash_attention.launches
    tokens = sum(len(r.out_tokens) for r in eng.finished)
    planned = [e for e in eng.migration_log if e["n_migrations"]]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_mb = N_LAYERS * RWKV_B * RWKV_H * RWKV_DH * RWKV_DH * 4 / 1e6
    log(f"main path rwkv6 (make_engine auto -> {type(eng).__name__}) bf16 "
        f"rwkv6-7b x{N_LAYERS} layers: {len(eng.finished)} requests, "
        f"{tokens} tokens, {eng.decode_steps} decode steps in {wall:.2f} s "
        f"({tokens / wall:.1f} tok/s); decode step median "
        f"{1e3 * float(np.median(eng.step_times)):.2f} ms; "
        f"{len(eng.interval_times)} controller intervals, mean "
        f"{1e3 * float(np.mean(eng.interval_times)):.1f} ms; straggler at "
        f"step {fired}; rwkv6_chunked launches {launches} (prefill "
        f"{prefill}, decode {launches - sum(prefill)})")
    log_split(eng, wall, prefill_time)
    log(f"  controller: {sum(e['n_migrations'] for e in planned)} head "
        f"migrations planned in {len(planned)} intervals, none applied "
        f"({NO_HEADS!r})")
    log(f"  memory: weights {weight_gb:.2f} GB, WKV state {state_mb:.1f} "
        f"MB, peak allocated {peak_gb:.2f} GB")
    check(len(eng.finished) == 16 and all(len(r.out_tokens) == RWKV_NEW
                                          for r in eng.finished),
          "rwkv6: not every request finished with its tokens")
    check(prefill == [N_LAYERS, N_LAYERS],
          f"rwkv6: prefill launches {prefill} != 2 waves x {N_LAYERS}")
    check(launches - sum(prefill) == eng.decode_steps * N_LAYERS
          == 2 * (RWKV_NEW - 1) * N_LAYERS,
          f"rwkv6: decode launches {launches - sum(prefill)} != decode "
          f"steps {eng.decode_steps} x {N_LAYERS} layers")
    check(not any(others.values()),
          f"rwkv6: an attention kernel launched: {others}")
    check(bool(planned), "rwkv6: the controller planned no head move")
    check(all(not e["applied"] and e["mig_bytes"] == 0 for e in
              eng.migration_log)
          and all(e["reason"] == NO_HEADS for e in planned),
          "rwkv6: an interval was logged as applied, or without the "
          "reference's reason")
    check(bool(seen["finite"].item()), "rwkv6: non-finite logits")
    return launches


def phase_rwkv6_stream_pair():
    """float32, 2 layers: the rwkv6 path with and without the WKV6
    kernel, from the same weights (nonzero adapters) and a straggler at
    step 8 (the first interval's), must stream the same greedy tokens with
    the same logs."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("rwkv6-7b").with_overrides(
        n_layers=2, dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    nonzero_adapters(params)
    keys = ("step", "n_migrations", "mig_bytes", "applied", "reason")
    runs = []
    for use_kernel in (True, False):
        eng = rwkv6_engine(cfg, use_kernel=use_kernel, n_requests=8,
                           prompt=256, max_new=24, params=params)
        head_straggler(eng, 8)
        logits, inner = [], eng.model.decode_step

        def decode_step(p, state, tokens, inner=inner, logits=logits):
            out, state = inner(p, state, tokens)
            logits.append(out.clone())
            return out, state

        eng.model.decode_step = decode_step
        eng.run()
        runs.append(({r.rid: r.out_tokens for r in eng.finished},
                     [tuple(m[k] for k in keys) for m in eng.migration_log],
                     logits))
        del eng
        release()
    (s0, l0, g0), (s1, l1, g1) = runs
    worst = max((a - b).abs().max().item() for a, b in zip(g0, g1))
    log(f"f32 streams rwkv6 kernel vs plain (2 layers): {len(s0)} requests, "
        f"max per-step logit difference {worst:.3e}, "
        f"{sum(m[1] for m in l0)} head migrations planned (none applied), "
        f"logs {'equal' if l0 == l1 else 'differ'}")
    check(len(s0) == 8 and s0 == s1, "rwkv6: greedy streams differ")
    check(l0 == l1, "rwkv6: migration logs differ")
    check(any(m[1] and not m[3] and m[4] == NO_HEADS for m in l0),
          "rwkv6: no head move was planned and logged as not applied")
    check(all(torch.isfinite(g).all().item() for g in g0 + g1),
          "rwkv6: non-finite logits")


# ------------------------------------------------ the flash attention kernel
def flash_inputs(dtype, *, B, H, KvE, Sq, Skv=None, dh=128, seed=0):
    """q (B, H, Sq, dh) and k, v (B, KvE, Skv, dh) as transposed views of
    the model's (B, S, H, dh) activations, standard normal from a seeded
    generator on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    Skv = Sq if Skv is None else Skv
    return (draw((B, Sq, H, dh)).transpose(1, 2),
            draw((B, Skv, KvE, dh)).transpose(1, 2),
            draw((B, Skv, KvE, dh)).transpose(1, 2))


def flash_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask admits, per (b, h)."""
    if not causal:
        return Sq * Skv
    i = np.arange(Sq)
    hi = np.minimum(i, Skv - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound_ms(q, k, causal, window):
    """Least time for the function on these inputs: q, k, v read once and
    o written once; 4 dh flops per admitted (query, key) pair per head
    (2 for q.k, 2 for p.v) at the tensor cores' rate for the dtype."""
    B, H, Sq, dh = q.shape
    Skv = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * dh * B * H * flash_pairs(Sq, Skv, causal, window)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# label -> (B, H, KvE, S, window, dh): the prefill attention of each path
# that runs the kernel, in bf16 — llama's largest bucket (the dense and
# int8 paths), mixtral's lock-step wave over its window, glm4's longest
# bucket, musicgen's largest bucket (MHA at dh 64)
FLASH_SHAPES = {
    "llama bucket": (1, 32, 8, 512, 0, 128),
    "mixtral wave": (RING_B, 32, 8, RING_PROMPT, RING_W, 128),
    "glm4": (1, 32, 2, GLM_HI, 0, 128),
    "musicgen bucket": (1, 32, 32, 512, 0, 64),
}


def phase_flash_vs_plain():
    """The flash kernel against its plain version (the model's own prefill
    arithmetic: ``attention_scores`` below a KV extent of 2048,
    ``chunked_attention`` at 2048 and above) at the four paths' bf16
    shapes, a ragged S = 1000 under a window, a non-causal case, Sq < Skv,
    MHA at dh 128 (qwen1.5-32b's heads), and float32; then its times at the
    four shapes beside the plain version, SDPA and the bound.  The glm4
    shape's go into the record."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(label, bf16, dict(B=B, H=H, KvE=KvE, Sq=S, dh=dh), True, w)
             for label, (B, H, KvE, S, w, dh) in FLASH_SHAPES.items()]
    cases += [
        ("ragged S=1000 window 300", bf16,
         dict(B=2, H=32, KvE=2, Sq=1000), True, 300),
        ("non-causal S=700", bf16, dict(B=1, H=32, KvE=8, Sq=700), False, 0),
        ("Sq=300 < Skv=2048", bf16, dict(B=1, H=32, KvE=2, Sq=300,
                                         Skv=2048), True, 0),
        ("llama bucket f32", f32, dict(B=1, H=32, KvE=8, Sq=512), True, 0),
        ("ragged S=1000 f32 GQA 16", f32, dict(B=1, H=32, KvE=2, Sq=1000),
         True, 0),
        ("qwen MHA S=700", bf16, dict(B=1, H=40, KvE=40, Sq=700), True, 0),
        ("musicgen bucket f32", f32, dict(B=1, H=32, KvE=32, Sq=512, dh=64),
         True, 0),
    ]
    worst = worst_rel = 0.0
    for i, (label, dt, shape, causal, window) in enumerate(cases):
        q, k, v = flash_inputs(dt, seed=i, **shape)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out, want)
        ok = torch.allclose(out.float(), want.float(), **TOLS[dt]) \
            and rel <= FLASH_ROW_REL[dt]
        log(f"flash_attention vs plain {str(dt)[6:]:8s} {label:26s} "
            f"{tuple(q.shape)} over {tuple(k.shape)} causal={causal} "
            f"window={window} max_abs_err={err:.3e} max_row_rel_err="
            f"{rel:.3e} (limit {FLASH_ROW_REL[dt]:.0e})")
        check(ok and torch.isfinite(out).all().item(),
              f"flash_attention disagrees with its plain version ({label})")
        if dt == bf16:
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        del q, k, v, out, want
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {}
    for label, (B, H, KvE, S, window, dh) in FLASH_SHAPES.items():
        # input copies together larger than the 50 MB L2, so every call
        # reads cold; long shapes are one copy and fewer timed calls
        small = S <= 1024
        sets = [flash_inputs(bf16, B=B, H=H, KvE=KvE, Sq=S, dh=dh,
                             seed=10 + c)
                for c in range(16 if small else 1)]
        kw = dict(causal=True, window=window)
        reps, n = (20, 50) if small else (2, 5)
        ms = cuda_ms([lambda a=a: flash_attention(*a, **kw) for a in sets],
                     reps=reps, n=n)
        plain_ms = cuda_ms([lambda a=a: flash_attention_plain(*a, **kw)
                            for a in sets], reps=reps if small else 1,
                           n=n if small else 3)
        # yardstick only: SDPA's causal mask is aligned at the top left as
        # the kernel's; a window needs a boolean mask
        mask = None
        if window and window < S:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
        lib_ms = cuda_ms([lambda a=a: sdpa(
            *a, attn_mask=mask, is_causal=mask is None, enable_gqa=H != KvE)
            for a in sets], reps=reps, n=n)
        bound, bound_by = flash_bound_ms(sets[0][0], sets[0][1], True, window)
        timed[label] = (ms, plain_ms, bound, bound_by, lib_ms)
        log(f"flash_attention bf16 {label} B={B} H={H} KvE={KvE} S={S} "
            f"dh={dh} window={window}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}, {flash_pairs(S, S, True, window)} pairs per "
            f"head)")
        del sets
        release()
    ms, plain_ms, bound, bound_by, lib_ms = timed["glm4"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:83",
            "max_abs_err": worst, "max_rel_err": worst_rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms,
            "shapes": {label: dict(zip(("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms"), t))
                       for label, t in timed.items()}}


# --------------------------------------------------------- the glm4 path
def random_qkv_bias(params, seed=0):
    """Set ``bq``/``bk``/``bv`` in place to 0.5 N(0, 1) from a seeded
    generator: the init leaves them at zero, which would hide a bias that
    did not move with its head."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    attn = params["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        t = attn[name]
        t.copy_(0.5 * torch.randn(t.shape, generator=gen, device="cuda"))


def auto_engine(cfg, *, use_kernel, n_requests, lo, hi, max_new, max_seq,
                params=None):
    """``make_engine(mode="auto")`` for ``cfg``: 8 slots, λ = 8, four
    simulated devices, ``n_requests`` prompts of ``lo``-``hi`` tokens from
    ``default_rng(0)``."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import make_engine
    eng = make_engine(cfg, mode="auto", n_slots=MAIN_B, max_seq=max_seq,
                      lam=8, seed=0, net=DeviceNetwork.sample(4, seed=1),
                      use_kernel=use_kernel, params=params, device="cuda")
    for p in traffic(n_requests, cfg.vocab_size, lo=lo, hi=hi):
        eng.submit(p, max_new_tokens=max_new)
    return eng


def drive_auto_path(path, eng, max_new):
    """Drive a continuous-batching path built by ``auto_engine`` to idle
    with every kernel's count set to 0 just before, a straggler at step 16
    on the busiest device; log its host-clock split and peak memory, and
    check that every request finished, an interval applied head
    migrations, the flash kernel launched ``FLASH_LAUNCHES[path]`` times,
    the resident decode kernel once a layer each decode step, and no other
    kernel.  Returns the decode and flash launches."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving.engine import ServingEngine
    cfg = eng.cfg
    check(isinstance(eng, ServingEngine),
          f"make_engine picked {type(eng).__name__} for {path}")
    weight_gb = sum(t.numel() * t.element_size() for t in
                    _leaves(eng.params)) / 1e9
    seen = watch_logits(eng)
    prefill = time_prefill(eng)
    kernels = [k for k, _, _ in PATHS.values()] + [
        "decode_attention_ring_resident"]
    torch.cuda.synchronize()
    for kernel in kernels:
        getattr(da, kernel).launches = 0
    flash_attention.launches = 0
    t0 = time.monotonic()
    while drive(eng):
        pass
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: getattr(da, k).launches for k in kernels}
    flash = flash_attention.launches
    decode = launches["decode_attention_resident"]
    tokens = sum(len(r.out_tokens) for r in eng.finished)
    applied = [e for e in eng.migration_log
               if e["applied"] and e["n_migrations"]]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path {path} (make_engine auto -> {type(eng).__name__}) "
        f"{DTYPE_NAMES[cfg.dtype]} {cfg.name} x{cfg.n_layers} layers: "
        f"{len(eng.finished)} requests, "
        f"{tokens} tokens, {eng.decode_steps} decode steps in {wall:.2f} s "
        f"({tokens / wall:.1f} tok/s); decode step median "
        f"{1e3 * float(np.median(eng.step_times)):.2f} ms; "
        f"{len(eng.interval_times)} controller intervals, mean "
        f"{1e3 * float(np.mean(eng.interval_times)):.1f} ms; "
        f"{sum(e['n_migrations'] for e in applied)} head migrations "
        f"({sum(e['mig_bytes'] for e in applied) / 1e6:.1f} MB) in "
        f"{len(applied)} applied intervals; prefill buckets "
        f"{sorted(eng.prefill_buckets_used)}; kernel launches {launches}, "
        f"flash_attention {flash}")
    log_split(eng, wall, prefill)
    log(f"  memory: weights {weight_gb:.2f} GB, peak allocated "
        f"{peak_gb:.2f} GB")
    check(len(eng.finished) == 16
          and all(len(r.out_tokens) == max_new for r in eng.finished),
          f"{path}: not every request finished with its {max_new} tokens")
    check(bool(applied), f"{path}: no interval applied a migration")
    check(flash == FLASH_LAUNCHES[path],
          f"{path}: flash_attention launches {flash} != "
          f"{FLASH_LAUNCHES[path]} (16 prefills x {cfg.n_layers} layers)")
    check(decode == eng.decode_steps * cfg.n_layers,
          f"{path}: decode kernel launches {decode} != decode steps "
          f"{eng.decode_steps} x {cfg.n_layers} layers")
    check(not any(n for k, n in launches.items()
                  if k != "decode_attention_resident"),
          f"{path}: another path's kernel launched: {launches}")
    check(bool(seen["finite"].item()), f"{path}: non-finite logits")
    graph_decode_step(eng)
    return decode, flash


def phase_glm4_path():
    """Serve 16 requests (2048-8192-token prompts, 64 new tokens each) on
    the full-width 4-layer glm4-9b through ``make_engine(mode="auto")``,
    which must pick the continuous engine: every bucketed prefill runs the
    flash kernel once per layer (buckets 4096 and 8192), every decode step
    the flash-decode kernel, and a straggler at step 16 on the busiest
    device makes an interval apply head migrations (moving the random
    biases with their heads).  Returns the decode kernel's and the flash
    kernel's launches."""
    from repro_torch.configs import get_config
    cfg = get_config("glm4-9b").with_overrides(n_layers=N_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = auto_engine(cfg, use_kernel=True, n_requests=16, lo=GLM_LO,
                      hi=GLM_HI, max_new=GLM_NEW, max_seq=GLM_MAX_SEQ)
    random_qkv_bias(eng.params)
    log("glm4 weights: random from seed 0, then bq, bk and bv set to "
        "seeded 0.5 N(0, 1) (the init leaves them at zero)")
    return drive_auto_path("glm4", eng, GLM_NEW)


def stream_pair(label, engines, straggle_at=8):
    """Drive two engines built from the same weights in step, a straggler
    at ``straggle_at``: their greedy streams and migration logs must be
    equal, with applied migrations, and every logit finite."""
    seen = [watch_logits(e) for e in engines]
    keys = ("step", "n_migrations", "mig_bytes", "applied")
    worst = 0.0
    while True:
        more = [drive(e, straggle_at=straggle_at) for e in engines]
        check(more[0] == more[1], f"{label}: the two engines stopped at "
              f"different steps")
        if not more[0]:
            break
        active = engines[0]._active()
        if active:
            worst = max(worst, (seen[0]["last"][active]
                                - seen[1]["last"][active]).abs().max().item())
    streams = [{r.rid: r.out_tokens for r in e.finished} for e in engines]
    logs = [[tuple(m[k] for k in keys) for m in e.migration_log]
            for e in engines]
    moved = [sum(m[1] for m in lg if m[3]) for lg in logs]
    log(f"f32 streams {label}: {len(streams[0])} requests, max per-step "
        f"logit difference {worst:.3e}, applied migrations {moved[0]} and "
        f"{moved[1]}, logs {'equal' if logs[0] == logs[1] else 'differ'}")
    check(len(streams[0]) == 8 and streams[0] == streams[1],
          f"{label}: greedy streams differ")
    check(logs[0] == logs[1], f"{label}: migration logs differ")
    check(min(moved) > 0, f"{label}: no migration was applied")
    check(all(bool(s["finite"].item()) for s in seen),
          f"{label}: non-finite logits")


def phase_glm4_stream_pair():
    """float32, 4 layers, biased: the glm4 path with the kernels (flash
    prefill, flash-decode) and without, from the same weights, 8 requests
    of 2048-4096 tokens and a straggler at step 8 (an interval applies
    head migrations at step 16), must stream the same greedy tokens with
    the same migration logs."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("glm4-9b").with_overrides(
        n_layers=N_LAYERS, dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    random_qkv_bias(params)
    engines = [auto_engine(cfg, use_kernel=uk, n_requests=8, lo=GLM_LO,
                           hi=4096, max_new=32, max_seq=4096 + 40,
                           params=params)
               for uk in (True, False)]
    stream_pair(f"glm4 kernels vs plain ({N_LAYERS} layers)", engines)
    del engines, params


# ----------------------------------------------------- the musicgen path
def random_norm_mlp_bias(params, seed=0):
    """Set the LayerNorm biases ``ln1_b``, ``ln2_b`` and ``ln_f_b`` and the
    GELU MLP's ``b_up`` and ``b_down`` in place to 0.5 N(0, 1) from a
    seeded generator: the init leaves them at zero, which would hide a
    bias the model drops."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    layers = params["layers"]
    for t in (layers["ln1_b"], layers["ln2_b"], params["ln_f_b"],
              layers["mlp"]["b_up"], layers["mlp"]["b_down"]):
        t.copy_(0.5 * torch.randn(t.shape, generator=gen, device="cuda"))


def phase_musicgen_path():
    """Serve the dense path's traffic (16 requests of 32-512 tokens, 64 new
    tokens each, an extent of 1024) on the full-width 4-layer
    musicgen-large (MHA: 32 q heads over 32 KV heads at dh 64, LayerNorm,
    GELU) through ``make_engine(mode="auto")``, which must pick the
    continuous engine: every bucketed prefill runs the flash kernel once
    per layer at H == KvE, every decode step the resident kernel at G 1,
    and a straggler at step 16 on the busiest device makes an interval
    apply head migrations.  Returns the decode kernel's and the flash
    kernel's launches."""
    from repro_torch.configs import get_config
    cfg = get_config("musicgen-large").with_overrides(n_layers=N_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = auto_engine(cfg, use_kernel=True, n_requests=16, lo=32, hi=512,
                      max_new=64, max_seq=MAIN_T)
    random_norm_mlp_bias(eng.params)
    log("musicgen weights: random from seed 0, then ln1_b, ln2_b, ln_f_b, "
        "b_up and b_down set to seeded 0.5 N(0, 1) (the init leaves them "
        "at zero)")
    return drive_auto_path("musicgen", eng, 64)


def phase_musicgen_stream_pair():
    """float32, 2 layers, biased: the musicgen path with the kernels (flash
    prefill on the CUDA-core body at H == KvE, the resident decode kernel's
    CUDA-core body at G 1) and without, from the same weights, 8 requests
    of 32-512 tokens and a straggler at step 8, must stream the same greedy
    tokens with the same migration logs."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("musicgen-large").with_overrides(
        n_layers=2, dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    random_norm_mlp_bias(params)
    engines = [auto_engine(cfg, use_kernel=uk, n_requests=8, lo=32, hi=512,
                           max_new=32, max_seq=MAIN_T, params=params)
               for uk in (True, False)]
    stream_pair("musicgen kernels vs plain (2 layers)", engines)
    del engines, params


# ---------------------------------------------------- the pipelined paths
# pipeline_k = 2: the dense path's 8 slots in 2 groups of 4, one group
# decoded a scheduler step, the controller's plans from the bottleneck
# search every λ·K = 16 steps.  Paged: pages of 64, 24 a group (48 in all,
# as the paged path).
PIPE_K = 2
PIPE_PATHS = {
    "dense": ("decode_attention_resident", {}),
    "paged": ("decode_attention_paged_resident",
              dict(paged=True, page_size=64, kv_pages=24)),
}
DECODE_KERNELS = ("decode_attention_resident",
                  "decode_attention_int8_resident",
                  "decode_attention_paged_resident",
                  "decode_attention_int8_paged_resident",
                  "decode_attention_ring_resident")


def phase_pipelined_path(path="dense"):
    """Serve the dense path's traffic (16 requests of 32-512 tokens, 64 new
    tokens each, a 500x straggler at step 16 on the busiest device) with
    ``pipeline_k=2`` and ``search="bottleneck"`` from the ``path`` cache:
    each step decodes one group of 4 rows through its kernel (an empty
    group launches nothing), every interval falls on a multiple of λ·K,
    and one applies a bottleneck-planned migration to both groups' caches.
    Returns the decode kernel's and the flash kernel's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention
    name, kw = PIPE_PATHS[path]
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS)
    eng = serve(cfg, use_kernel=True, n_requests=16, max_new=64,
                pipeline_k=PIPE_K, search="bottleneck", **kw)
    seen = watch_logits(eng)
    prefill = time_prefill(eng)
    torch.cuda.synchronize()
    for kernel in DECODE_KERNELS:
        getattr(da, kernel).launches = 0
    flash_attention.launches = 0
    t0 = time.monotonic()
    while drive(eng):
        pass
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: getattr(da, k).launches for k in DECODE_KERNELS}
    flash = flash_attention.launches
    tokens = sum(len(r.out_tokens) for r in eng.finished)
    cadence = eng.lam * eng.pipeline_k
    applied = [e for e in eng.migration_log
               if e["applied"] and e["n_migrations"] and e["reason"] is None]
    rows = {int(st["pos"].shape[0]) for st in eng.states}
    log(f"pipelined path {path} (K {eng.pipeline_k}, {eng.rows_per_group} "
        f"rows a group, search {eng.controller._policy.search}) bf16 "
        f"llama3-8b x{N_LAYERS} layers: {len(eng.finished)} requests, "
        f"{tokens} tokens, {eng.decode_steps} scheduler steps "
        f"({len(eng.step_times)} group decodes) in {wall:.2f} s "
        f"({tokens / wall:.1f} tok/s); decode step median "
        f"{1e3 * float(np.median(eng.step_times)):.2f} ms; "
        f"{len(eng.interval_times)} controller intervals, mean "
        f"{1e3 * float(np.mean(eng.interval_times)):.1f} ms; "
        f"{sum(e['n_migrations'] for e in eng.migration_log)} head "
        f"migrations in {len(applied)} applied intervals; kernel launches "
        f"{launches}, flash_attention {flash}")
    log_split(eng, wall, prefill)
    check(len(eng.finished) == 16 and all(len(r.out_tokens) == 64
                                          for r in eng.finished),
          f"pipelined {path}: not every request finished with its 64 "
          f"tokens")
    check(rows == {MAIN_B // PIPE_K}, f"pipelined {path}: group states of "
          f"{rows} rows")
    check(launches[name] == len(eng.step_times) * cfg.n_layers,
          f"pipelined {path}: kernel launches {launches[name]} != group "
          f"decodes {len(eng.step_times)} x {cfg.n_layers} layers")
    check(not any(n for k, n in launches.items() if k != name),
          f"pipelined {path}: another path's kernel launched: {launches}")
    check(flash == FLASH_LAUNCHES[path],
          f"pipelined {path}: flash_attention launches {flash} != "
          f"{FLASH_LAUNCHES[path]}")
    check(bool(eng.migration_log) and all(
        e["step"] % cadence == 0 for e in eng.migration_log),
        f"pipelined {path}: an interval off the {cadence}-step cadence: "
        f"{[e['step'] for e in eng.migration_log]}")
    check(eng.controller._policy is not None
          and eng.controller._policy.search == "bottleneck",
          f"pipelined {path}: the controller's plans are not the "
          f"bottleneck search's")
    check(bool(applied), f"pipelined {path}: no interval applied a "
          f"migration")
    check(bool(seen["finite"].item()),
          f"pipelined {path}: non-finite logits")
    if eng.paged:
        for alloc in eng.allocators:
            alloc.check_invariants()
        live = [a.live_pages for a in eng.allocators]
        log(f"  paged pools {eng.kv_pages} pages of {eng.page_size} a "
            f"group: admission waited {eng.page_waits} scheduler steps; "
            f"{live} pages live after drain")
        check(not any(live), f"pipelined {path}: pages live after drain")
    return launches[name], flash


def run_to_end(eng, straggle_at):
    """Drive one engine until it is idle, a straggler at ``straggle_at``
    (None: none); returns its streams."""
    while drive(eng, straggle_at=straggle_at):
        pass
    return {r.rid: r.out_tokens for r in eng.finished}


def phase_pipelined_stream_pairs():
    """float32, 2 layers, shared weights, 8 requests of 32 new tokens; each
    engine runs to its end (a pipelined engine takes more scheduler steps
    than a sequential one).  The pipelined engine with the kernels, the
    bottleneck search and the straggler must stream the sequential plain
    engine's tokens with no migration, having applied migrations; and the
    paged pipelined engine the dense pipelined one's, both with the
    kernels."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    pipe = dict(pipeline_k=PIPE_K, search="bottleneck")
    sides = {
        "pipelined kernel": (dict(use_kernel=True, **pipe), 16),
        "sequential plain": (dict(use_kernel=False, lam=10 ** 9), None),
        "paged pipelined kernel": (dict(use_kernel=True, paged=True,
                                        page_size=64, **pipe), 16),
    }
    streams, moved = {}, {}
    for label, (kw, straggle_at) in sides.items():
        eng = serve(cfg, n_requests=8, max_new=32, params=params, **kw)
        seen = watch_logits(eng)
        streams[label] = run_to_end(eng, straggle_at)
        moved[label] = sum(e["n_migrations"] for e in eng.migration_log
                           if e["applied"])
        check(bool(seen["finite"].item()), f"{label}: non-finite logits")
        del eng, seen
        release()
    for a, b in (("pipelined kernel", "sequential plain"),
                 ("paged pipelined kernel", "pipelined kernel")):
        log(f"f32 streams {a} vs {b} (2 layers): {len(streams[a])} "
            f"requests, streams {'equal' if streams[a] == streams[b] else 'differ'}, "
            f"applied migrations {moved[a]} and {moved[b]}")
        check(len(streams[a]) == 8 and streams[a] == streams[b],
              f"{a} vs {b}: greedy streams differ")
        check(moved[a] > 0, f"{a}: no migration was applied")
    check(moved["sequential plain"] == 0,
          "the sequential plain engine migrated")
    del params


# ------------------------------------- the load, async and elastic paths
# The seeded load: Poisson arrivals at 0.1 a scheduler step over 160 steps
# (17 requests), prompts of 32-512 tokens, 64 new tokens each — about 80 %
# of what the 48-page pool (pages of 64) serves at once.  One scheduler
# step is one unit of the virtual clock, so TTFT and ITL are in steps.
LOAD = dict(rate=0.1, horizon=160.0, seed=11,
            prompt_mix=((1.0, 32, 512),), out_mix=((1.0, 64, 64),))
LOAD_PAGED = dict(paged=True, page_size=64, kv_pages=48)
T_FAIL, T_REJOIN = 40.0, 100.0


def load_workload(vocab: int):
    from repro_torch.serving.workload import make_workload
    return make_workload("poisson", vocab=vocab, **LOAD)


def load_engine(cfg, *, lam=8, params=None, **kw):
    """The load paths' engine: 8 slots, a 1024-token cache, four
    simulated devices, the kernels."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(cfg, n_slots=MAIN_B, max_seq=MAIN_T, lam=lam,
                         seed=0, net=DeviceNetwork.sample(4, seed=1),
                         use_kernel=True, device="cuda", params=params, **kw)


def reset_launches():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention
    torch.cuda.synchronize()
    for k in DECODE_KERNELS:
        getattr(da, k).launches = 0
    flash_attention.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention
    out = {k: getattr(da, k).launches for k in DECODE_KERNELS}
    out["flash_attention"] = flash_attention.launches
    return out


def log_load_metrics(label, m, eng, wall):
    tokens = sum(len(r.out_tokens) for r in eng.finished)
    log(f"{label}: {m['n_finished']}/{m['n_submitted']} requests, {tokens} "
        f"tokens, {m['steps']} scheduler steps to t {m['t_end']:.1f}; TTFT "
        f"p50/p95/p99 {m['p50_ttft']:.2f}/{m['p95_ttft']:.2f}/"
        f"{m['p99_ttft']:.2f} steps, ITL p50/p95/p99 {m['p50_itl']:.2f}/"
        f"{m['p95_itl']:.2f}/{m['p99_itl']:.2f} steps, goodput "
        f"{m['goodput']:.3f} tokens a step; wall {wall:.2f} s "
        f"({tokens / wall:.1f} tok/s), decode step median "
        f"{1e3 * float(np.median(eng.step_times)):.2f} ms; "
        f"{len(eng.interval_times)} controller intervals"
        + (f", mean {1e3 * float(np.mean(eng.interval_times)):.1f} ms"
           if eng.interval_times else "")
        + f"; admission waited {eng.page_waits if eng.paged else 0} steps")


def check_drained(label, eng):
    if eng.paged:
        for alloc in eng.allocators:
            alloc.check_invariants()
        live = [a.live_pages for a in eng.allocators]
        check(not any(live), f"{label}: pages live after the drain: {live}")


def phase_load_path():
    """Serve the seeded Poisson load (``LOAD``) on the paged llama3-8b
    engine (pages of 64, a pool of 48, λ 8) through ``drive_virtual``:
    every request finishes, the pool drains, and the paged kernel launched
    once a layer on every scheduler step that had active rows.  Returns
    the workload's size and the paged kernel's launches."""
    from repro_torch.configs import get_config
    from repro_torch.serving.workload import drive_virtual, offered_load
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS)
    reqs = load_workload(cfg.vocab_size)
    eng = load_engine(cfg, **LOAD_PAGED)
    seen = watch_logits(eng)
    prefill = time_prefill(eng)
    reset_launches()
    t0 = time.monotonic()
    m = drive_virtual(eng, reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    off = offered_load(reqs, LOAD["horizon"])
    log(f"load path (drive_virtual, Poisson {LOAD['rate']} a step, "
        f"{len(reqs)} requests, offered {off['tok_rate']:.1f} tokens a "
        f"step) paged bf16 llama3-8b x{N_LAYERS} layers")
    log_load_metrics("  load path", m, eng, wall)
    log(f"  kernel launches {launches}")
    log_split(eng, wall, prefill)
    name = "decode_attention_paged_resident"
    check(m["n_finished"] == len(reqs) == m["n_submitted"],
          f"load path: {m['n_finished']}/{len(reqs)} requests finished")
    check(all(len(r.out_tokens) == 64 for r in eng.finished),
          "load path: a request ended short of its 64 tokens")
    check(launches[name] == len(eng.step_times) * cfg.n_layers,
          f"load path: paged kernel launches {launches[name]} != decode "
          f"steps with active rows {len(eng.step_times)} x {cfg.n_layers}")
    check(len(eng.step_times) == eng.decode_steps == m["steps"],
          "load path: a scheduler step decoded no row")
    check(not any(n for k, n in launches.items() if k != name),
          f"load path: another kernel launched: {launches}")
    check(bool(seen["finite"].item()), "load path: non-finite logits")
    check_drained("load path", eng)
    return len(reqs), launches[name]


def phase_async_path():
    """The load workload through ``AsyncServingEngine(queue_limit=n + 1)``,
    every request submitted in arrival order up front, on a paged engine
    with no intervals (λ 10^9): its bf16 streams must equal those of
    ``drive_virtual`` on an engine built the same way, bit for bit, and
    the drain must leave no live page.  Logs the handles' wall TTFT.
    Returns the async run's paged kernel launches."""
    import asyncio

    from repro_torch.configs import get_config
    from repro_torch.serving.async_runtime import AsyncServingEngine
    from repro_torch.serving.workload import drive_virtual
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS)
    reqs = load_workload(cfg.vocab_size)
    sync = drive_virtual(load_engine(cfg, lam=10 ** 9, **LOAD_PAGED), reqs)
    release()
    eng = load_engine(cfg, lam=10 ** 9, **LOAD_PAGED)
    seen = watch_logits(eng)
    prefill = time_prefill(eng)

    async def serve_all():
        async with AsyncServingEngine(eng, queue_limit=len(reqs) + 1) as rt:
            handles = [rt.submit(r.prompt, max_new_tokens=r.max_new_tokens)
                       for r in sorted(reqs, key=lambda r: r.t_arrival)]
            await rt.drain()
        return handles

    reset_launches()
    t0 = time.monotonic()
    handles = asyncio.run(serve_all())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()["decode_attention_paged_resident"]
    streams = {h.rid: list(h.tokens) for h in handles}
    ttft = [1e3 * (h.t_first - h.t_submit) for h in handles]
    tokens = sum(len(t) for t in streams.values())
    log(f"async path (AsyncServingEngine over the paged engine, λ 10^9, "
        f"{len(reqs)} requests submitted at once): {tokens} tokens in "
        f"{wall:.2f} s ({tokens / wall:.1f} tok/s), {eng.decode_steps} "
        f"decode steps; wall TTFT p50/p95/p99 "
        + "/".join(f"{np.percentile(ttft, p):.1f}" for p in (50, 95, 99))
        + f" ms; paged kernel launches {launches}; streams "
        f"{'equal' if streams == sync['streams'] else 'differ'} to "
        f"drive_virtual's")
    log_split(eng, wall, prefill)
    check(all(h.error is None for h in handles), "async path: a handle "
          "failed")
    check(len(streams) == len(reqs) and streams == sync["streams"],
          "async path: bf16 streams differ from drive_virtual's")
    check(launches == eng.decode_steps * cfg.n_layers,
          f"async path: paged kernel launches {launches} != decode steps "
          f"{eng.decode_steps} x {cfg.n_layers}")
    check(bool(seen["finite"].item()), "async path: non-finite logits")
    check(len(eng.queue) == 0 and not eng._active(),
          "async path: the drain left work behind")
    check_drained("async path", eng)
    return launches


def restart_vs_evac(eng, plan, rec) -> float:
    """``benchmarks/elastic_serving``'s recovery comparison for one
    failure: steps to evacuate (the plan's migration delay over its
    per-token delay, plus the replay) against steps to restart (every
    placed block re-sent from the controller node at the link rates, plus
    the same replay)."""
    net, place = eng.net, np.asarray(plan["place"])
    step = float(plan["d_pipe_est"])
    check(bool(np.isfinite(step) and step > 0), "elastic path: the "
          "evacuated placement has no finite per-token delay")
    tau = max(int(plan["tau"]), 2)
    restore = 0.0
    for b in eng.controller.blocks:
        rate = net.bandwidth[net.controller, int(place[b.index])]
        if np.isfinite(rate):
            restore += eng.cost.memory(b, tau - 1) / rate
    evac = math.ceil(plan["d_mig_est"] / step) + rec["replay_steps"]
    restart = math.ceil(restore / step) + rec["replay_steps"]
    return restart / max(evac, 1)


def churn_events(info, slow=False):
    """``drive_virtual`` events: at ``T_FAIL`` the active device holding
    the most heads (never the network's controller node) fails (or, with
    ``slow``, runs 8x slower); at ``T_REJOIN`` it rejoins.  ``info``
    collects the device, the plans made while it was down, the fail
    event's host ms and the slots active when it fired."""
    def pick(eng):
        counts = eng.controller.head_counts().astype(float)
        counts[eng.net.controller] = -1
        counts[~eng.net.active] = -1
        return int(counts.argmax())

    def fail(eng):
        dev = info["device"] = pick(eng)
        info["slots"] = len(eng._active())
        info["inflight"] = sum(len(eng.slots[s].out_tokens)
                               for s in eng._active())
        inner = eng.controller.step_interval

        def recorded(*a, **k):
            plan = inner(*a, **k)
            if not eng.net.is_active(dev):
                info["plans_down"].append(np.asarray(plan["place"]).copy())
            return plan

        info["plans_down"] = []
        eng.controller.step_interval = recorded
        torch.cuda.synchronize()
        t0 = time.monotonic()
        info["plan"] = eng.fail_device(dev)
        torch.cuda.synchronize()
        info["fail_ms"] = 1e3 * (time.monotonic() - t0)

    def rejoin(eng):
        eng.rejoin_device(info["device"])

    if slow:
        return [(T_FAIL, lambda eng: eng.slow_device(pick(eng), 8.0))]
    return [(T_FAIL, fail), (T_REJOIN, rejoin)]


def phase_elastic_path(path="paged"):
    """The load workload on the ``path`` engine (λ 8) with churn: at t 40
    the busiest non-controller device fails mid-decode (evacuation, then
    teacher-forced replay of every in-flight stream), at t 100 it rejoins.
    Checks the recovery log, zero lost tokens, a replay that decoded, no
    block on the dead device in any plan while it was down, every request
    finished, the pool drained, and exact launch counts with the replay:
    the decode kernel once a layer on every live and every replay step;
    dense, flash once a layer on every admission and every replay
    prefill.  Returns the decode kernel's and the flash kernel's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.serving.workload import drive_virtual
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS)
    reqs = load_workload(cfg.vocab_size)
    kw = LOAD_PAGED if path == "paged" else {}
    name = "decode_attention_paged_resident" if path == "paged" \
        else "decode_attention_resident"
    eng = load_engine(cfg, **kw)
    seen = watch_logits(eng)
    prefill = time_prefill(eng)
    info = {}
    reset_launches()
    t0 = time.monotonic()
    m = drive_virtual(eng, reqs, events=churn_events(info))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    rec = eng.recovery_log
    fail = rec[0] if rec else {}
    x = restart_vs_evac(eng, info["plan"], fail) if fail else float("nan")
    log(f"elastic path {path} (drive_virtual, device {info.get('device')} "
        f"fails at t {T_FAIL:g} with {info.get('slots')} slots active, "
        f"rejoins at t {T_REJOIN:g}) bf16 llama3-8b x{N_LAYERS} layers")
    log_load_metrics(f"  elastic {path}", m, eng, wall)
    log(f"  fail event {info.get('fail_ms', float('nan')):.1f} ms of host "
        f"time (plan, migration, replay of {fail.get('replayed_slots')} "
        f"slots: {fail.get('replay_prefills')} prefills, "
        f"{fail.get('replay_steps')} decode steps; "
        f"{len(info['plan']['migrations']) if fail else 0} head blocks "
        f"evacuated); d_mig_est "
        f"{fail.get('d_mig_est', float('nan')):.4g} s, d_pipe_est "
        f"{fail.get('d_pipe_est', float('nan')):.4g} s; x_restart_vs_evac "
        f"{x:.3f}; tokens lost {eng.tokens_lost} (a restart would lose "
        f"{info.get('inflight')}); kernel launches {launches}")
    log_split(eng, wall, prefill)
    dev = info.get("device")
    check([r["event"] for r in rec] == ["fail", "rejoin"],
          f"elastic {path}: recovery log {rec}")
    check(dev is not None and dev != eng.net.controller,
          f"elastic {path}: failed device {dev} is the controller node")
    check(info["slots"] > 0, f"elastic {path}: the failure fired into an "
          f"idle engine")
    check(fail["tokens_lost"] == 0 and eng.tokens_lost == 0,
          f"elastic {path}: tokens lost")
    check(fail["replay_steps"] > 0, f"elastic {path}: replay decoded "
          f"nothing")
    check(len(info["plan"]["migrations"]) > 0, f"elastic {path}: the "
          f"evacuation moved no head (device {dev} held none)")
    check(bool(info["plans_down"]) and not any(
        np.any(p == dev) for p in info["plans_down"]),
        f"elastic {path}: a plan placed a block on dead device {dev}")
    check(eng.net.is_active(dev), f"elastic {path}: device {dev} did not "
          f"rejoin")
    check(m["n_finished"] == len(reqs) and all(
        len(r.out_tokens) == 64 for r in eng.finished),
        f"elastic {path}: {m['n_finished']}/{len(reqs)} requests finished")
    want = (len(eng.step_times) + fail["replay_steps"]) * cfg.n_layers
    check(launches[name] == want,
          f"elastic {path}: {name} launches {launches[name]} != (decode "
          f"steps {len(eng.step_times)} + replay steps "
          f"{fail['replay_steps']}) x {cfg.n_layers}")
    check(not any(n for k, n in launches.items()
                  if k not in (name, "flash_attention")),
          f"elastic {path}: another kernel launched: {launches}")
    want_flash = 0 if path == "paged" else \
        (len(reqs) + fail["replay_prefills"]) * cfg.n_layers
    check(launches["flash_attention"] == want_flash,
          f"elastic {path}: flash_attention launches "
          f"{launches['flash_attention']} != {want_flash}")
    check(bool(seen["finite"].item()), f"elastic {path}: non-finite logits")
    check_drained(f"elastic {path}", eng)
    return launches[name], launches["flash_attention"]


def phase_churn_stream_pairs():
    """float32, 2 layers, shared weights, the kernels, λ 8, the load
    workload: on a dense and a paged engine, the fail+rejoin run and the
    slow run (8x at t 40 on the busiest non-controller device) must each
    stream what the churn-free run streams, every request finishing."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.workload import drive_virtual
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    reqs = load_workload(cfg.vocab_size)
    for path, kw in (("dense", {}), ("paged", LOAD_PAGED)):
        runs = {}
        for label in ("churn-free", "fail+rejoin", "slow"):
            eng = load_engine(cfg, params=params, **kw)
            seen = watch_logits(eng)
            info = {}
            events = None if label == "churn-free" else \
                churn_events(info, slow=label == "slow")
            m = drive_virtual(eng, reqs, events=events)
            check(m["n_finished"] == len(reqs),
                  f"f32 {path} {label}: not every request finished")
            check(bool(seen["finite"].item()),
                  f"f32 {path} {label}: non-finite logits")
            check_drained(f"f32 {path} {label}", eng)
            runs[label] = (m["streams"], eng.recovery_log,
                           sum(e["n_migrations"] for e in eng.migration_log
                               if e["applied"]))
            del eng, seen
            release()
        for label in ("fail+rejoin", "slow"):
            same = runs[label][0] == runs["churn-free"][0]
            log(f"f32 streams {path} {label} vs churn-free (2 layers, "
                f"kernels): {len(runs[label][0])} requests, streams "
                f"{'equal' if same else 'differ'}, recovery "
                f"{[r['event'] for r in runs[label][1]]}, applied "
                f"migrations {runs[label][2]} and {runs['churn-free'][2]}")
            check(same, f"f32 {path} {label}: streams differ from the "
                  f"churn-free run's")
        check([r["event"] for r in runs["fail+rejoin"][1]]
              == ["fail", "rejoin"], f"f32 {path}: recovery log "
              f"{runs['fail+rejoin'][1]}")
        check(runs["fail+rejoin"][1][0]["replay_steps"] > 0,
              f"f32 {path}: replay decoded nothing")
    del params


def kernel_phases():
    """Every kernel against its plain version, then timed at its main
    path's shapes: one record per kernel."""
    return [phase_kernel_vs_plain()] + phase_new_kernels_vs_plain() \
        + [phase_ring_vs_plain(), phase_rwkv6_vs_plain(),
           phase_flash_vs_plain()]


def kernel_times(records):
    """{kernel: ms} from kernel records, and every shape of a record that
    carries ``shapes`` (the resident, WKV6 and flash kernels), beside SDPA
    where a shape has a library time."""
    out = {r["name"]: r["ms"] for r in records}
    for r in records:
        for label, t in r.get("shapes", {}).items():
            out[f"{r['name']} [{label}]"] = t["ms"]
            if t["library_ms"] is not None:
                out[f"{r['name']} [{label}] sdpa"] = t["library_ms"]
    return out


def ab(roots):
    """Times the kernels of several checkouts in turns, on one card: for
    each root, a fresh process builds that checkout's kernels and runs
    this script's kernel phases on them (``--kernels-of``), so every
    checkout is checked and timed by the same code.  Kernel times move
    within 2 % between turns and more between calls, so two versions are
    compared inside one call, in turns (parent, change, change, parent)."""
    turns = []
    for i, root in enumerate(roots):
        log(f"=== turn {i + 1}: {root}")
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--kernels-of", str(Path(root).resolve())],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stdout.write(proc.stderr[-4000:])
        check(proc.returncode == 0, f"the turn in {root} failed "
              f"(exit {proc.returncode})")
        lines = [x for x in proc.stdout.splitlines()
                 if x.startswith('{"kernels"')]
        turns.append(kernel_times(json.loads(lines[-1])["kernels"]))
    log("ms per turn (" + ", ".join(map(str, roots)) + "):")
    for name in dict.fromkeys(n for t in turns for n in t):
        log(f"  {name}: " + ", ".join(
            f"{t[name]:.4f}" if name in t else "-" for t in turns))
    print(json.dumps({"roots": list(map(str, roots)), "turns": turns}))


def main():
    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one NVIDIA GPU (see the module doc).")
    ap.add_argument("--ab", nargs="+", metavar="ROOT",
                    help="only time the kernels of these checkouts, in "
                    "turns (e.g. build/parent . . build/parent)")
    ap.add_argument("--kernels-of", metavar="ROOT",
                    help="only build ROOT's kernels and run the kernel "
                    "phases on them; print their records")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is present")
    if args.ab:
        return ab(args.ab)
    src = Path(args.kernels_of or ROOT).resolve() / "src"
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    if args.kernels_of:
        built = build.build(["decode_attention", "rwkv6", "flash_attention"])
        log(f"kernels of {build.__file__}: built {sorted(built)}")
        log_ptxas(built)
        print(json.dumps({"kernels": kernel_phases()}))
        return
    card = card_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log(f"card: {card}")
    t0 = time.monotonic()
    logs = build.build(["decode_attention", "rwkv6", "flash_attention"])
    log(f"built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.monotonic() - t0:.1f} s")
    log_ptxas(logs)
    log(f"flash library SASS: {check_flash_sass()} HGMMA instructions")
    records = kernel_phases()
    by_name = {r["name"]: r for r in records}
    release()
    phase_paged_equals_dense()
    release()
    # each path's launches: its decode kernel's in that kernel's record,
    # the flash kernel's logged; the flash record carries glm4's
    flash = {}
    for path, (name, _, _) in PATHS.items():
        by_name[name]["launches"], flash[path] = phase_main_path(path)
        release()
    by_name["decode_attention_ring_resident"]["launches"], \
        flash["mixtral"] = phase_mixtral_ring()
    release()
    by_name["rwkv6_chunked"]["launches"] = phase_rwkv6_path()
    flash["rwkv6"] = 0          # checked inside the phase
    release()
    _, flash["glm4"] = phase_glm4_path()
    by_name["flash_attention"]["launches"] = flash["glm4"]
    release()
    _, flash["musicgen"] = phase_musicgen_path()
    release()
    # the pipelined paths' launches (B = 4 rows a group) are logged; each
    # kernel's record keeps its sequential path's
    pipelined = {}
    for path in PIPE_PATHS:
        pipelined[path], flash[f"pipelined {path}"] = \
            phase_pipelined_path(path)
        release()
    log(f"decode kernel launches per pipelined path: {pipelined}")
    log(f"flash_attention launches per main path: {flash}")
    phase_stream_equality()
    release()
    phase_mixtral_stream_pair()
    phase_rwkv6_stream_pair()
    phase_glm4_stream_pair()
    release()
    phase_musicgen_stream_pair()
    release()
    phase_pipelined_stream_pairs()
    release()
    # the load, async and elastic paths' launches are logged; each
    # kernel's record keeps its sequential path's
    churn = {}
    n_load, churn["load paged"] = phase_load_path()
    release()
    churn["async paged"] = phase_async_path()
    release()
    for path in ("paged", "dense"):
        churn[f"elastic {path}"], flash[f"elastic {path}"] = \
            phase_elastic_path(path)
        release()
    log(f"decode kernel launches on the load, async and elastic paths "
        f"({n_load} requests): {churn}")
    log(f"flash_attention launches with the elastic paths: {flash}")
    phase_churn_stream_pairs()
    release()
    print(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
