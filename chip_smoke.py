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
seeded random values) at full width (4 layers) on the dense path's traffic;
and ``make_engine(mode="auto")`` serving llama-3.2-vision-11b (gated
cross-attention over 1601-row image K/V, its gates set nonzero) at full
width (2 supergroups: 8 self + 2 cross layers) on the dense path's traffic
with images of 1601, 1025 and 0 rows; and ``make_engine(mode="auto")``
serving zamba2-2.7b (the Mamba-2 backbone in plain torch, its seeded conv
bias, decays, dt bias and skip nonzero; the shared attention block at
head width 80 through flash and the resident decode kernel) at full width
(2 of 9 supergroups) under the wave scheduler, its head plans logged as
not applied — and checks that each path went through its kernels, with
exact launch counts.  The whole 54-layer zamba2 then prefills and decodes
through both kernels, without an engine, and so does the whole 32-layer
mixtral-8x7b on int8 weights (drawn a layer at a time; 46.7 GB where
bf16 would need 93.4) with GShard capacity dispatch: 4 x 4096-token
prompts through windowed flash, 64 steps through the ring kernel.  The
4-layer mixtral holds capacity dispatch at cf E/k to dense dispatch and
a replicated expert to the unreplicated model; f32 streams on int8
weights (mixtral, llama3-8b) are equal with and without the kernels; the
identity-row wrappers ``decode_attention`` and ``decode_attention_int8``
are held to their plain versions and timed.  It then serves a seeded
Poisson load on the paged llama3-8b engine through ``drive_virtual``, the same load through
``AsyncServingEngine`` (bf16 streams equal to ``drive_virtual``'s), and
the load with a device failing mid-decode and rejoining on the paged and
dense engines (evacuation and teacher-forced replay, launch counts exact
with the replay).  The dense path is served again in the tensor-parallel
head layout of degree 16 (``ServingEngine(tp=16)``: llama3-8b's 8 KV heads
each replicated twice in the cache, the resident kernel at G 2,
replica-aware migrations applied), and so is qwen1.5-32b at published
widths (4 layers; 40 heads zero-padded to 48, its padded rows checked
zero after every migration); float32 tp-16 streams equal the tp-1 ones
and themselves without the kernels; and on a (1, 1) ("data", "model")
DeviceMesh over NCCL llama3-8b's params are placed, saved, restored
through ``elastic_restore`` (every sha1 equal) and run the sharded
forward through the flash kernel; the four decode kernels run on each
head shard of the tp-4 layout with a straggler plan's rank-local rows
(held to their plain versions and, put together, to the whole call), and
so does the ring kernel on mixtral-8x7b's; ``ServingEngine(part=...)``
serves llama3-8b (4 layers) sharded on that mesh from each cache kind,
each rank's KV shard placed by the decode-state rules, with streams equal
to the unsharded engine's; and ``make_engine(part=...)`` serves
mixtral-8x7b (4 layers) on a (1, 1, 1) ("pod", "data", "model") mesh
through the wave engine over its ring, experts placed over "pod", with
streams equal to the unsharded engine's; the WKV6 kernel runs on
rwkv6-7b's tp-4 head shards (bit-equal, put together, to the whole
call) and zamba2's shared block's flash and resident kernels on its
head shards; and ``make_engine(part=...)`` serves rwkv6-7b (4 layers)
and zamba2-2.7b (2 supergroups) on the (1, 1) mesh, their recurrent
layers on local tensors, with streams equal to the unsharded engine's;
and musicgen-large (4 layers) and llama-3.2-vision-11b (2 supergroups) on
that mesh, each rank's KV cache and image K/V shard placed by the
decode-state rules and written in place, with streams equal to the
unsharded engine's; llama3-8b (all 32 layers), zamba2-2.7b (all 54) and
mixtral-8x7b (4 layers, dense and capacity dispatch) prefill and decode
on int8 weights placed on one-card meshes, their logits equal to the
unsharded model's; and mixtral-8x7b (4 layers, without its window)
serves paged, from bf16 and int8 pages, on a (1, 1, 1) mesh with a page
pool for each batch rank, with streams, admissions and logs equal to the
unsharded paged engine's.  The VLM also serves from an int8 cache (the
int8 kernel on its self layers), and its f32 int8 streams are equal with
and without the kernels.  Every prefill whose queries and keys share their positions
(bucketed, lock-step, ring) runs the flash attention kernel.  It checks
that the paged decode kernels give the linear ones' output bit for bit on
the same cache in scrambled pages, and in float32 that greedy streams
with and without the kernels, from paged and dense caches, and with and
without a device failure or slowdown, are equal.  The hot-path audit
(``repro_torch.analysis``) then checks one decode step of the main path
from each cache kind and of the mixtral ring through their kernels: no
host sync under ``torch.cuda.set_sync_debug_mode("error")``, no finding
of the dispatch-trace audit, caches in place, a memory rise under the
cache's bytes and a CUDA-graph capture; the prefill traces bounded by the
buckets through flash; and the auditor's CLI on the card exits 0.  Then
long-decode under the reference's ``seq_over_data`` rules at its
long_500k shape (524,288 tokens, batch 1): the resident kernel's LSE
output over 4 sequence shards of zamba2's shared block and the ring
kernel's over 4 slot shards of mixtral's window, merged and held against
the whole call; then zamba2-2.7b (2 supergroups, a 10.7 GB cache),
mixtral-8x7b (4 layers, its ring) and rwkv6-7b (4 layers) take 64 greedy
steps from a seeded state at position 524,224 on one-rank meshes under
``make_partitioner(seq_over_data=True)``, with streams and logits equal
to the unsharded model's.

Last it trains, on the plain path (the kernels have no backward and
refuse autograd): one step of four reduced float32 families on the card
against the CPU; ``launch.train.main`` on paper-gpt at its published
config (B 8 x S 512, 300 steps, checkpoints every 150, the loss falling)
and a resume from step 150 equal to the uninterrupted run bit for bit;
the trained weights then serve through the flash and resident decode
kernels (f32 streams equal to the plain path's, launch counts exact, and
``ServingEngine(use_kernel=True)`` on the bf16 weights); and train steps
at llama3-8b's published widths (4 layers), split into forward+backward
and the AdamW update.  Then it trains on a (1, 1) ("data", "model") NCCL
mesh through ``launch.steps.train_cell`` — the reference's train cell:
fsdp, sequence parallelism, remat "full" — one reduced float32 step of
every family (llama3-8b under the zero3 layout too) against the
unsharded step on the card, and five bf16 steps of llama3-8b x4 at
published widths on B 1 x S 4096 beside five unsharded ones (step
split, peak memory, loss curves); no kernel launches there.

    python3 chip_smoke.py --ab build/parent . . build/parent

times the kernels of several checkouts in turns instead (see ``ab``), and
with ``--paths`` serves the paged and int8-paged main paths in each and
compares their host-clock splits;
``--only train`` builds the kernels and runs only the training phases;
``--only tp`` the decode and flash kernel phases, the dense path and the
tp-16, mesh and shard phases; ``--only ssm`` the recurrent families'
shard and mesh phases; ``--only audio_vlm`` the VLM from an int8 cache
(bf16 path and f32 stream pair) and musicgen and the VLM served sharded
on the one-card mesh; ``--only mesh_mem`` int8 weights and the paged MoE
on one-card meshes; ``--only audit`` the hot-path audit; ``--only long``
the long-decode phase; ``--only train_mesh`` training on the one-card
mesh.

Output: progress lines, then the card's ``name, power.limit`` line, a JSON
line ``{"kernels": [...]}`` with each kernel's launches on the main path,
error, times and bound, and last ``{"ok": true, "device": {...}}``.  Any
failed phase raises, exiting non-zero before the result lines.  Without a
GPU, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
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
# the VLM path: llama-3.2-vision-11b cut to 2 supergroups of [3 self,
# 1 gated cross, 1 self] — 8 self-attention layers (flash at prefill, the
# resident kernel at decode) and 2 cross layers (the resident kernel at
# decode over the image K/V; plain masked attention at prefill, as the
# reference)
VLM_LAYERS = 10
VLM_SELF = VLM_LAYERS // 5 * 4
# the zamba2 path: zamba2-2.7b at full width cut to 2 of its 9 supergroups
# (12 mamba layers, the shared attention block at the top of every 6, so
# one weight copy serves two caches); 8 slots, 16 requests of 1024 tokens
# (2 waves), 64 new tokens each, an extent of 1096.  The shared block
# prefills through flash (B 8, 32 heads of 80, H == KvE) and decodes
# through the resident kernel at G 1, once a supergroup each.
ZAMBA_LAYERS, ZAMBA_EVERY = 12, 6
ZAMBA_GROUPS = ZAMBA_LAYERS // ZAMBA_EVERY
ZAMBA_B, ZAMBA_PROMPT, ZAMBA_NEW, ZAMBA_MAX_SEQ = 8, 1024, 64, 1096
ZAMBA_DECODE = dict(B=ZAMBA_B, H=32, KvE=32, dh=80, T=ZAMBA_MAX_SEQ)
# the lock-step wave's lengths at its last decode step, and a mixed set
# with 0, 1 and T
ZAMBA_LOCKSTEP = [ZAMBA_PROMPT + ZAMBA_NEW] * ZAMBA_B
ZAMBA_MIXED = [1, ZAMBA_MAX_SEQ, 1088, 0, 517, 64, 65, ZAMBA_MAX_SEQ - 1]
NO_CACHE = "state has no addressable KV cache"
FLASH_LAUNCHES = {"dense": 16 * N_LAYERS, "paged": 0,
                  "int8": 16 * N_LAYERS, "int8_paged": 0,
                  "mixtral": 2 * N_LAYERS, "rwkv6": 0,
                  "glm4": 16 * N_LAYERS, "musicgen": 16 * N_LAYERS,
                  "vlm": 16 * VLM_SELF, "vlm int8": 16 * VLM_SELF,
                  "zamba2": 2 * ZAMBA_GROUPS}
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
# the VLM path's cross-attention decode: 32 q heads over 8 KV heads (G 4)
# at dh 128 over the 1601-token image K/V of one cross layer, a view into
# the (G, B, I, KvE, dh) stack; rows hold a full image (1601 rows), one
# 448x448 tile (1025) or none (length 0, patched to the mean of V after
# the kernel)
VLM_IMG, VLM_TILE = 1601, 1025
VLM_CROSS = dict(B=MAIN_B, H=32, KvE=8, dh=128, T=VLM_IMG, stack=2)
VLM_CROSS_LENGTHS = [VLM_IMG, VLM_TILE, 0] * 2 + [VLM_IMG, VLM_TILE]
# the tensor-parallel layout at tp 16, served on one card: llama3-8b's 8
# KV heads each replicated twice into 16 cache rows (G 2), qwen1.5-32b's
# 40 heads zero-padded to 48, one KV head each (G 1)
TP = 16
TP_LLAMA_DECODE = dict(B=MAIN_B, H=32, KvE=16, dh=128, T=MAIN_T)
TP_QWEN_DECODE = dict(B=MAIN_B, H=48, KvE=48, dh=128, T=MAIN_T)
QWEN_REAL_HEADS = 40
DTYPE_NAMES = {"bfloat16": "bf16", "float32": "f32"}
# Capacity dispatch at cf E/k (no token dropped) against dense dispatch,
# and a replicated expert against the unreplicated model, per row of bf16
# last-token logits (vocab 32000): the same function summed in another
# order and rounded to bf16 at other points, down 4 layers.  A dropped
# token, a wrong gate or share moves a row by O(1) of its norm.
CAPACITY_ROW_REL = 5e-2
# f32 streams with and without the kernels: every step's logits (the
# summation order only; earlier f32 pairs read <= 3.3e-5, PERF.md)
STREAM_LOGIT_ATOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.monotonic()


def log(msg: str):
    """A progress line, stamped with the seconds since the script
    started (the phases' times are the differences)."""
    print(f"[chip_smoke {time.monotonic() - _T0:.1f} s] {msg}", flush=True)


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
    """The built flash library's SASS must hold warpgroup MMA (``HGMMA``)
    in the wgmma body of every head width: the bf16 prefill runs on
    wgmma.  Returns the count of HGMMA instructions, in all and per head
    width."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import SUPPORTED_DH
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    per_dh = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = _FLASH.search(part.split("\n", 1)[0])
        if name and name.group(1) == "wgmma":
            per_dh[int(name.group(2))] = len(re.findall(r"\bHGMMA\.",
                                                        part))
    n = len(re.findall(r"\bHGMMA\.", sass))
    check(n > 0 and set(per_dh) == set(SUPPORTED_DH)
          and all(per_dh.values()),
          f"the flash library's SASS lacks HGMMA in a wgmma body: {per_dh}")
    return n, dict(sorted(per_dh.items()))


# ---------------------------------------------------------------- phase 2
def _group_perm(rng, H, G):
    groups = rng.permutation(H // G)
    return np.concatenate([g * G + rng.permutation(G) for g in groups])


def decode_inputs(dtype, *, B=MAIN_B, H=MAIN_H, KvE=MAIN_KVE, dh=MAIN_DH,
                  T=MAIN_T, rows="identity", lengths=None, seed=0, stack=0):
    """Kernel-layout inputs; K/V are transposed views of a cache in the
    model's (B, T, KvE, dh) layout, as the main path passes them — with
    ``stack`` > 0, of the last layer of a (stack, B, T, KvE, dh) stack (the
    VLM's image K/V)."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((B, H, dh), np.float32))
    lead = (stack,) if stack else ()
    kc = torch.from_numpy(rng.standard_normal(lead + (B, T, KvE, dh),
                                              np.float32))
    vc = torch.from_numpy(rng.standard_normal(lead + (B, T, KvE, dh),
                                              np.float32))
    if stack:
        kc, vc = kc.to(dev, dtype)[-1], vc.to(dev, dtype)[-1]
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
    one q row a KV head) at the musicgen path's shape (dh 64),
    qwen1.5-32b's heads (40 at dh 128) and the zamba2 path's (32 at dh 80,
    T 1096, lock-step and mixed lengths), and the VLM's cross-attention
    (T 1601 through a view into the image K/V stack, rows of length 0),
    each held to TOLS and to DECODE_ROW_REL per (b, resident row), with
    faults planted in the cross-attention and dh-80 shapes' outputs that
    the bound must catch; then its times at the dense shape (ragged and
    full lengths), the glm4, musicgen, VLM cross-attention and zamba2
    shapes beside the plain version, SDPA and the bound.  The dense
    shape's go into the record, every shape's into its ``shapes``."""
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
    # the VLM's cross-attention: views into a stack of image K/V, T 1601
    # (no multiple of a split or a tile), rows of length 0 among full ones
    cases += [(dt, "identity", dict(VLM_CROSS, lengths=VLM_CROSS_LENGTHS))
              for dt in (torch.float32, torch.bfloat16)]
    # the tp-16 layouts: llama3-8b at KvE 16 with G 2, qwen1.5-32b's 48
    # padded heads at G 1, over the dense path's extent
    cases += [(dt, rows, dict(shape, lengths=lengths))
              for shape in (TP_LLAMA_DECODE, TP_QWEN_DECODE)
              for dt in (torch.float32, torch.bfloat16)
              for rows in ("identity", "group_perm")]
    # zamba2's shared attention: MHA at dh 80 (G 1) over its extent of
    # 1096 (no multiple of a tile of 32 past 1088), lock-step and mixed
    # lengths, on both bodies
    cases += [(dt, rows, dict(ZAMBA_DECODE, lengths=lens))
              for dt in (torch.float32, torch.bfloat16)
              for rows, lens in (("identity", ZAMBA_LOCKSTEP),
                                 ("identity", ZAMBA_MIXED),
                                 ("group_perm", ZAMBA_MIXED))]
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
    cross_faults_caught()
    dh80_faults_caught()

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
                                                 lengths=lengths)),
            ("vlm cross", lambda lens: lens,
             dict(VLM_CROSS, lengths=VLM_CROSS_LENGTHS)),
            ("zamba2", lambda lens: lens,
             dict(ZAMBA_DECODE, lengths=ZAMBA_LOCKSTEP)),
            ("llama tp16", lambda lens: lens,
             dict(TP_LLAMA_DECODE, lengths=lengths)),
            ("qwen tp16", lambda lens: lens,
             dict(TP_QWEN_DECODE, lengths=lengths))):
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


def cross_faults_caught():
    """The per-row bound catches the faults the cross-attention shape
    (T 1601, rows of length 0) invites, each planted in the plain
    version's output: a kernel that drops the last split of a row (the
    split that holds the partial tile) on random inputs, and one that
    drops a row's last position, on inputs where that position's key
    carries most of the row's softmax weight (a "needle": 4 times the
    mean of its KV group's q rows).  The kernel itself must pass the
    needle case."""
    from repro_torch.kernels.decode_attention import (
        _decode_split, _sm_count, decode_attention_resident,
        decode_attention_resident_plain)
    dt, limit = torch.bfloat16, DECODE_ROW_REL[torch.bfloat16]
    q, k, v, lens, r = decode_inputs(dt, seed=99, lengths=VLM_CROSS_LENGTHS,
                                     **VLM_CROSS)
    B, H, _ = q.shape
    KvE, T = k.shape[1], k.shape[2]
    split = _decode_split(B, KvE, T, _sm_count(q.device))
    want = decode_attention_resident_plain(q, k, v, lens, r)
    last_split = torch.where(lens > 0, (lens - 1) // split * split, lens)
    rel_split = row_rel_err(
        decode_attention_resident_plain(q, k, v, last_split, r), want)
    G = H // KvE
    for b, n in enumerate(VLM_CROSS_LENGTHS):
        if n:
            k[b, :, n - 1] = (4 * q[b].view(KvE, G, -1).float().mean(1)
                              ).to(dt)
    out = decode_attention_resident(q, k, v, lens, r)
    torch.cuda.synchronize()
    want = decode_attention_resident_plain(q, k, v, lens, r)
    rel_needle = row_rel_err(out, want)
    rel_last = row_rel_err(decode_attention_resident_plain(
        q, k, v, (lens - 1).clamp_min(0), r), want)
    log(f"cross-attention bound (bf16, T={T}, lengths "
        f"{VLM_CROSS_LENGTHS}, split {split}): kernel on the needle inputs "
        f"max_row_rel_err={rel_needle:.3e}; planted faults: last split "
        f"dropped {rel_split:.3e}, last position dropped (needle) "
        f"{rel_last:.3e}; limit {limit:.0e}")
    check(rel_needle <= limit, "the kernel fails the needle case")
    check(rel_split > limit and rel_last > limit,
          "the cross-attention bound misses a planted fault")


def dh80_faults_caught():
    """The per-row bound catches the faults head width 80 invites, each
    planted in the plain version's output at the zamba2 shape (bf16,
    mixed lengths): a kernel that drops the last 16 columns of V (the
    tail .x2 load: output columns 64-79 zero) or of K (scores over 64 of
    80 columns), and one that drops each row's last split.  The kernel's
    own rows on the same inputs are logged beside them."""
    from repro_torch.kernels.decode_attention import (
        _decode_split, _sm_count, decode_attention_resident,
        decode_attention_resident_plain as plain)
    dt, limit = torch.bfloat16, DECODE_ROW_REL[torch.bfloat16]
    q, k, v, lens, r = decode_inputs(dt, seed=80, lengths=ZAMBA_MIXED,
                                     **ZAMBA_DECODE)
    B, KvE, T = q.shape[0], k.shape[1], k.shape[2]
    split = _decode_split(B, KvE, T, _sm_count(q.device))
    want = plain(q, k, v, lens, r)
    out = decode_attention_resident(q, k, v, lens, r)
    torch.cuda.synchronize()
    rel_kernel = row_rel_err(out, want)
    v_cut = want.clone()
    v_cut[..., 64:] = 0
    k_cut = k.clone()
    k_cut[..., 64:] = 0
    last_split = torch.where(lens > 0, (lens - 1) // split * split, lens)
    rel = {"V's last 16 columns": row_rel_err(v_cut, want),
           "K's last 16 columns": row_rel_err(plain(q, k_cut, v, lens, r),
                                              want),
           "each row's last split": row_rel_err(
               plain(q, k, v, last_split, r), want)}
    log(f"dh 80 bound (bf16, T={T}, lengths {ZAMBA_MIXED}, split {split}): "
        f"kernel max_row_rel_err={rel_kernel:.3e}; planted faults: "
        + ", ".join(f"{n} dropped {e:.3e}" for n, e in rel.items())
        + f"; limit {limit:.0e}")
    check(rel_kernel <= limit, "the kernel fails the dh 80 fault inputs")
    check(min(rel.values()) > limit, "the dh 80 bound misses a planted "
          "fault")


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


def kv_inputs(kind, dtype, *, rows="identity", lengths=None, seed=0, P=64,
              **shape):
    """Kernel-layout arguments of the ``kind`` kernel ("dense", "int8",
    "paged", "int8_paged") at the main path's shapes (``shape`` overrides
    them: ``decode_inputs``'s B, H, KvE, dh, T): K/V and scales are
    transposed views of the model's (B, T, KvE, dh) cache or (n_pages, P,
    KvE, dh) page store; int8 values and scales come from the port's
    ``_q8``."""
    from repro_torch.models.layers import _q8
    q, k, v, lens, r = decode_inputs(dtype, rows=rows, lengths=lengths,
                                     seed=seed, **shape)
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
    at the main path's shapes and at head width 80 (zamba2's: G 4 as the
    main path, and G 1 over 32 KV heads) (bf16 and f32; identity,
    group-permuted and partial rows; lengths 0, 1, T-1, T, T+1; paged at
    P = 64 and 8 over a scrambled pool), then their times at the main
    path's bf16 shapes.
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
        for i, (shape, dt, rows, P) in enumerate(
                (shape, dt, rows, P)
                for shape in ({}, dict(dh=80), dict(KvE=32, dh=80))
                for dt in (torch.float32, torch.bfloat16)
                for rows in ("identity", "group_perm", "partial")
                for P in ((64, 8) if "paged" in kind else (None,))):
            args = kv_inputs(kind, dt, rows=rows, lengths=lengths, seed=i,
                             P=P or 64, **shape)
            out = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = (out.float() - want.float()).abs().max().item()
            rel = row_rel_err(out, want)
            ok = torch.allclose(out.float(), want.float(), **TOLS[dt]) \
                and rel <= DECODE_ROW_REL[dt]
            log(f"{name} vs plain {str(dt)[6:]:8s} rows={rows:10s}"
                f"{f' P={P}' if P else ''} dh={args[0].shape[2]} "
                f"KvE={args[1].shape[1]} max_abs_err={err:.3e} "
                f"max_row_rel_err={rel:.3e} (limit "
                f"{DECODE_ROW_REL[dt]:.0e})")
            if not (ok and torch.isfinite(out).all().item()
                    and not out[0].any().item()):
                bad.append(f"{str(dt)[6:]} {rows} P={P} {shape}")
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


# the reference's dense-grid wrappers: the resident builders over identity
# rows; here the split body of the kind's resident entry point
IDENTITY_KERNELS = {   # wrapper -> (kv_inputs kind, TPU function it ports)
    "decode_attention": ("dense",
                         "src/repro/kernels/decode_attention.py:520"),
    "decode_attention_int8": ("int8",
                              "src/repro/kernels/decode_attention.py:127"),
}


def phase_identity_wrappers_vs_plain():
    """``decode_attention`` and ``decode_attention_int8`` (the split body
    over identity rows, R == H) against their plain versions at the dense
    path's shape (B 8, H 32, KvE 8, dh 128, T 1024; lengths 0, 1, T-1, T,
    T+1 and between): f32 and bf16 q over K/V of q's dtype, and over int8
    K/V with scales, held to TOLS and DECODE_ROW_REL per (b, head); then
    timed at bf16 beside the plain version, the bound and (fp) SDPA.  No
    serving path calls them (the models decode through the resident, paged
    and ring entry points with their row maps), so a record's launches are
    this phase's checked calls."""
    from repro_torch.kernels import decode_attention as da
    lengths = [0, 1, MAIN_T - 1, MAIN_T, MAIN_T + 1, 37, 512, 700]
    records, failed = [], []
    for name, (kind, replaces) in IDENTITY_KERNELS.items():
        kern, plain = getattr(da, name), getattr(da, name + "_plain")
        kern.launches = 0
        worst = worst_rel = 0.0
        bad = []
        for i, dt in enumerate((torch.float32, torch.bfloat16)):
            args = kv_inputs(kind, dt, lengths=lengths, seed=40 + i)[:-1]
            out = kern(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = (out.float() - want.float()).abs().max().item()
            rel = row_rel_err(out, want)
            log(f"{name} vs plain {str(dt)[6:]:8s} (identity rows) "
                f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e} (limit "
                f"{DECODE_ROW_REL[dt]:.0e})")
            if not (torch.allclose(out.float(), want.float(), **TOLS[dt])
                    and rel <= DECODE_ROW_REL[dt]
                    and torch.isfinite(out).all().item()
                    and not out[0].any().item()):
                bad.append(str(dt)[6:])
            worst = max(worst, err)
            if dt == torch.bfloat16:
                worst_rel = max(worst_rel, rel)
        launches = kern.launches
        if bad:
            failed.append(f"{name} disagrees with its plain version: {bad}")
            continue
        sets = [kv_inputs(kind, torch.bfloat16, lengths=lengths, seed=s)
                for s in range(8)]
        ms = cuda_ms([lambda a=a: kern(*a[:-1]) for a in sets])
        plain_ms = cuda_ms([lambda a=a: plain(*a[:-1]) for a in sets])
        bound, bound_by = kv_bound_ms(kind, sets[0])
        lib = None
        if kind == "dense":
            lib = cuda_ms([sdpa_decode(*a) for a in sets])
        log(f"{name} bf16 B={MAIN_B} H={MAIN_H} KvE={MAIN_KVE} dh={MAIN_DH} "
            f"T={MAIN_T} lengths={lengths}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, "
            + (f"sdpa {lib:.4f} ms, " if lib is not None else
               "library_ms null (no single PyTorch call reads int8 K/V "
               "with scales), ")
            + f"bound {bound:.4f} ms ({bound_by}); {launches} checked "
            f"launches")
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": worst, "max_rel_err": worst_rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib})
        release()
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


def ring_inputs(dtype, *, n_written, lengths, rows="identity", seed=0,
                dh=MAIN_DH):
    """Kernel-layout arguments of the ring kernel at the mixtral path's
    shapes (B 4, H 32, KvE 8, dh 128 unless given, window 4096): K/V are
    transposed views of a (B, window, KvE, dh) ring as the model passes
    them."""
    q, k, v, lens, r = decode_inputs(
        dtype, B=RING_B, T=RING_W, rows=rows, lengths=lengths, seed=seed,
        dh=dh)
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
    written positions) and resident rows under a group permutation (also
    at head width 80), each
    held to TOLS and to RING_ROW_REL per (b, resident row); then its time
    on the main path's bf16 inputs (a full wrapped ring)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_ring_resident as kern,
        decode_attention_ring_resident_plain as plain)
    cases = [("wrapped", 8192, [8192, 8000, 6001, 4097], "identity", 128),
             ("partly_filled", 3000, [1, 37, 4095, 4096], "identity", 128),
             ("permuted", 8192, [8192, 5000, 4500, 4097], "group_perm",
              128),
             ("permuted dh 80", 8192, [8192, 5000, 4500, 4097],
              "group_perm", 80),
             ("partly_filled dh 80", 3000, [1, 37, 4095, 4096], "identity",
              80)]
    worst = worst_rel = 0.0
    bad = []
    for i, (dt, (label, n, lengths, rows, dh)) in enumerate(
            (dt, c) for dt in (torch.float32, torch.bfloat16)
            for c in cases):
        args = ring_inputs(dt, n_written=n, lengths=lengths, rows=rows,
                           seed=i, dh=dh)
        out = kern(*args, window=RING_W)
        torch.cuda.synchronize()
        want = plain(*args, window=RING_W)
        err = (out.float() - want.float()).abs().max().item()
        rel = row_rel_err(out, want)
        ok = torch.allclose(out.float(), want.float(), **TOLS[dt]) \
            and rel <= RING_ROW_REL[dt]
        log(f"decode_attention_ring_resident vs plain {str(dt)[6:]:8s} "
            f"{label:19s} rows={rows:10s} max_abs_err={err:.3e} "
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
    """The host-clock split of a main path's wall time; returns it in
    seconds."""
    decode_s, interval_s = sum(eng.step_times), sum(eng.interval_times)
    log(f"  host-clock split of {wall:.2f} s: decode steps {decode_s:.2f} s, "
        f"controller intervals {interval_s:.2f} s, prefill "
        f"{prefill['s']:.2f} s ({prefill['calls']} calls), admission, "
        f"sampling and the rest "
        f"{wall - decode_s - interval_s - prefill['s']:.2f} s")
    return {"wall": wall, "decode steps": decode_s,
            "controller intervals": interval_s, "prefill": prefill["s"],
            "prefill calls": prefill["calls"]}


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


# each main path's host-clock split in seconds (``log_split``), by path
SPLITS = {}
# the main paths ``--ab --paths`` serves in each checkout: those whose
# prefill chunks run the plain attention on the card
AB_PATHS = ("paged", "int8_paged")


def path_metrics(eng, wall) -> dict:
    tokens = sum(len(r.out_tokens) for r in eng.finished)
    return {"tok/s": tokens / wall,
            "step median ms": 1e3 * float(np.median(eng.step_times)),
            "interval mean ms": 1e3 * float(np.mean(eng.interval_times))}


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
    SPLITS[path] = log_split(eng, wall, prefill)
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
                   params=None, n_slots=RING_B, **kw):
    """``make_engine(mode="auto")`` for ``cfg`` over an 8192-token extent
    (a ring of the 4096-token window), λ = 8, four simulated devices, with
    ``n_requests`` 4096-token prompts from ``default_rng(seed)``; ``kw``
    goes to the engine (a partitioner)."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import make_engine
    eng = make_engine(cfg, mode="auto", n_slots=n_slots, max_seq=8192,
                      lam=8, seed=0, net=DeviceNetwork.sample(4, seed=1),
                      use_kernel=use_kernel, params=params, device="cuda",
                      **kw)
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


def int8_layerwise(cfg, device, seed=0):
    """``quantize_params`` of random weights for ``cfg``, drawn one layer
    at a time: layer l is a 1-layer model's ``init`` from seed ``seed + l``,
    quantized and copied into slot l of int8 stacks (and their float32
    scales) allocated once; the embeddings, head and final norm are the
    first draw's.  A full model's float weights need not fit at once (the
    bf16 mixtral-8x7b, 93.4 GB, does not), and since every scale is per
    layer this equals ``quantize_params`` of the stacked draws bit for bit
    (``tests/test_torch_quant.py``)."""
    from repro_torch.models.api import build_model
    from repro_torch.models.quantization import quantize_params
    one = build_model(cfg.with_overrides(n_layers=1), device=device)

    def draw(l):
        return quantize_params(one.init(
            torch.Generator(device=device).manual_seed(seed + l)))

    def alloc(tree):
        if isinstance(tree, dict):
            return {k: alloc(v) for k, v in tree.items()}
        return torch.empty((cfg.n_layers,) + tree.shape[1:],
                           dtype=tree.dtype, device=device)

    def put(dst, src, l):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], l)
        else:
            dst[l].copy_(src[0])

    params = draw(0)
    layers = alloc(params["layers"])
    put(layers, params["layers"], 0)
    for l in range(1, cfg.n_layers):
        put(layers, draw(l)["layers"], l)
    params["layers"] = layers
    return params


def _drop_counter():
    """Patches the transformer's capacity MoE call to also count, per
    call, the (token, expert row) assignments it drops (``moe.
    capacity_drops``: the router run again on the same input).  Returns
    the list the counts land in and the function that removes the patch."""
    from repro_torch.models import transformer
    from repro_torch.models.moe import capacity_drops
    inner, drops = transformer.moe_block_capacity, []

    def counting(cfg, p, x, capacity_factor=1.25, group=1024, **kw):
        drops.append(capacity_drops(cfg, p, x, capacity_factor, group))
        return inner(cfg, p, x, capacity_factor, group, **kw)

    transformer.moe_block_capacity = counting

    def undo():
        transformer.moe_block_capacity = inner
    return drops, undo


def _weight_bytes(params):
    """(bytes as held, bytes the same weights take in bf16): int8 values
    count 2 bytes each in bf16, every other leaf as it is."""
    held = bf16 = 0
    for t in _leaves(params):
        held += t.numel() * t.element_size()
        bf16 += t.numel() * (2 if t.dtype == torch.int8 else
                             t.element_size())
    return held, bf16


def _scale_bytes(tree):
    """Bytes of the float32 scales of a tree's int8 leaves."""
    if not isinstance(tree, dict):
        return 0
    if "q8" in tree:
        return tree["sc"].numel() * tree["sc"].element_size()
    return sum(_scale_bytes(v) for v in tree.values())


def phase_mixtral_int8_full_depth(card):
    """The whole 32-layer mixtral-8x7b at published widths with int8
    weights (``quantize_params``'s layout, drawn a layer at a time by
    ``int8_layerwise``: its 93.4 GB of bf16 do not fit the card), no
    engine: ``build_model(cfg, use_kernel=True, capacity_moe=True)``,
    a ring state for 4 rows over the 4096-token window, a lock-step
    prefill of 4 x 4096 tokens (windowed flash, capacity dispatch at cf
    1.25) and 64 greedy decode steps through the ring kernel.  Flash
    launches once a layer, the ring kernel once a layer a step, no other
    decode kernel; the logits are finite.  Returns (ring, flash)
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.api import build_model
    cfg = get_config("mixtral-8x7b")
    L_ = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = int8_layerwise(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    draw_s = time.monotonic() - t0
    held, bf16 = _weight_bytes(params)
    scales = _scale_bytes(params)
    draw_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, use_kernel=True, capacity_moe=True,
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (RING_B, RING_PROMPT),
                           generator=gen, device="cuda")
    state = model.init_decode_state(params, RING_B, RING_PROMPT + RING_NEW)
    check("pos" in state["cache"], "mixtral int8: no ring cache")
    hd = model.hd
    ring_gb = sum(state["cache"][n].numel() * state["cache"][n].element_size()
                  for n in ("k", "v")) / 1e9
    reset_launches()
    drops, undo = _drop_counter()
    try:
        t0 = time.monotonic()
        logits, state = model.prefill(params, state, tokens)
        torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
    finally:
        undo()
    flash = flash_attention.launches
    finite = torch.isfinite(logits).all()
    steps = []
    for _ in range(RING_NEW):
        t0 = time.monotonic()
        logits, state = model.decode_step(params, state, logits.argmax(-1))
        torch.cuda.synchronize()
        steps.append(time.monotonic() - t0)
        finite &= torch.isfinite(logits).all()
    launches = read_launches()
    ring = launches.pop("decode_attention_ring_resident")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    drops = [int(d) for d in drops]
    assigned = RING_B * RING_PROMPT * cfg.experts_per_token
    log(f"mixtral int8 full depth ({L_} layers, d {cfg.d_model}, {hd.H} q / "
        f"{hd.KvE} KV heads of {hd.dh}, {cfg.n_experts} experts of d_ff "
        f"{cfg.d_ff}, capacity dispatch at cf 1.25; card {card}): weights "
        f"{held / 1e9:.2f} GB int8 ({scales / 1e6:.2f} MB of scales; "
        f"{bf16 / 1e9:.2f} GB in bf16), drawn a layer at a time in "
        f"{draw_s:.1f} s; ring K/V {ring_gb:.2f} GB; peak allocated "
        f"{peak_gb:.2f} GB serving ({draw_gb:.2f} GB while drawing)")
    log(f"  prefill {RING_B} x {RING_PROMPT} tokens {prefill_s:.2f} s (with "
        f"the drop count's second router pass); decode step median "
        f"{1e3 * float(np.median(steps)):.2f} ms over {RING_NEW} steps "
        f"(min {1e3 * min(steps):.2f}); flash_attention {flash}, "
        f"decode_attention_ring_resident {ring}, others {launches}")
    log(f"  tokens dropped by capacity in the prefill, per layer (of "
        f"{assigned} assignments): {drops}; total {sum(drops)} "
        f"({100 * sum(drops) / (assigned * L_):.3f} %)")
    parts = dequant_breakdown(cfg, params)
    n_w = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
    one, two = parts["dequantize_weight"], parts["two-kernel form"]
    layer_ms = one + parts["bf16 products"]
    log(f"  one layer's expert work at decode (layer 0, {n_w / 1e9:.2f}·10⁹ "
        f"int8 weights, CUDA graphs): "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        + f" (dequantize_weight {3 * n_w / one / 1e6:.0f} GB/s of 3 bytes a "
        f"weight, the two-kernel form {11 * n_w / two / 1e6:.0f} GB/s of "
        f"11); x {L_} layers: {L_ * layer_ms:.1f} ms of the "
        f"{1e3 * float(np.median(steps)):.2f} ms step")
    check(len(drops) == L_, f"mixtral int8: {len(drops)} capacity calls "
          f"in the prefill, not {L_}")
    check(flash == L_, f"mixtral int8: flash launches {flash} != {L_}")
    check(ring == RING_NEW * L_, f"mixtral int8: ring launches {ring} != "
          f"{RING_NEW} steps x {L_} layers")
    check(not any(n for k, n in launches.items() if k != "flash_attention"),
          f"mixtral int8: another decode kernel launched: {launches}")
    check(bool(finite.item()), "mixtral int8 full depth: non-finite logits")
    del model, params, state, logits
    return ring, flash


def dequant_breakdown(cfg, params):
    """Device ms of one layer's expert work in a decode step, as CUDA
    graphs: layer 0's three int8 expert stacks dequantized to bf16 by
    ``dequantize_weight`` and by the two-kernel form with the same bits
    (``q8 * sc`` to float32, then the cast), and the three bf16 expert
    products at the step's ``RING_B`` rows.  Each stack (0.47·10⁹
    weights) is far larger than the L2, so every call reads cold.
    Returns {label: ms for the three stacks}."""
    from repro_torch.models.quantization import (_broadcast_scale,
                                                 dequantize_weight)
    bf = torch.bfloat16
    stacks = {n: {k: t[0] for k, t in params["layers"]["moe"][n].items()}
              for n in ("w_gate", "w_up", "w_down")}

    def two_kernels(leaf):
        return (leaf["q8"] * _broadcast_scale(leaf["sc"], 3)).to(bf)

    out = {}
    for label, fn in (("dequantize_weight", lambda l: dequantize_weight(l,
                                                                         bf)),
                      ("two-kernel form", two_kernels)):
        out[label] = sum(cuda_ms([lambda l=l: fn(l)], reps=5, n=10)
                         for l in stacks.values())
        release()
    w = {n: dequantize_weight(l, bf) for n, l in stacks.items()}
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((cfg.n_experts, RING_B, cfg.d_model), generator=gen,
                    device="cuda", dtype=bf)
    h = torch.randn((cfg.n_experts, RING_B, cfg.d_ff), generator=gen,
                    device="cuda", dtype=bf)
    out["bf16 products"] = sum(cuda_ms([lambda a=a, b=b: a @ b])
                               for a, b in ((x, w["w_gate"]),
                                            (x, w["w_up"]),
                                            (h, w["w_down"])))
    return out


def mixtral4_params():
    """The 4-layer bf16 mixtral's weights (the ring path's draw)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("mixtral-8x7b").with_overrides(n_layers=N_LAYERS)
    return cfg, build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))


def phase_mixtral_capacity(cfg, params):
    """The 4-layer bf16 mixtral at published widths, one lock-step prefill
    of 4 x 4096 tokens into the ring state (flash, windowed) with dense
    dispatch and with capacity dispatch at cf E/k (cap == group: nothing
    dropped) and at the default 1.25.  Capacity at E/k computes dense
    dispatch's function: its last-token logits must be within
    CAPACITY_ROW_REL per row of dense's.  Each prefill runs twice and the
    second is timed."""
    from repro_torch.models.api import build_model
    E_k = cfg.n_experts / cfg.experts_per_token
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (RING_B, RING_PROMPT),
                           generator=gen, device="cuda")
    runs = {}
    for label, kw in (("dense", {}),
                      (f"capacity cf {E_k:g}",
                       dict(capacity_moe=True, capacity_factor=E_k)),
                      ("capacity cf 1.25", dict(capacity_moe=True))):
        model = build_model(cfg, use_kernel=True, device="cuda", **kw)
        for _ in range(2):
            state = model.init_decode_state(params, RING_B,
                                            RING_PROMPT + RING_NEW)
            drops, undo = _drop_counter()
            try:
                torch.cuda.synchronize()
                t0 = time.monotonic()
                logits, state = model.prefill(params, state, tokens)
                torch.cuda.synchronize()
                secs = time.monotonic() - t0
            finally:
                undo()
            del state
        # rpr: ignore[RPR004] -- read once a configuration, after timing
        runs[label] = (logits, secs, [int(d) for d in drops])
        log(f"mixtral {N_LAYERS} layers bf16 prefill {RING_B} x "
            f"{RING_PROMPT} tokens, {label}: {secs:.3f} s"
            + (f"; dropped per layer {runs[label][2]}" if drops else ""))
    want = runs["dense"][0]
    exact = runs[f"capacity cf {E_k:g}"]
    rel = row_rel_err(exact[0], want)
    rel125 = row_rel_err(runs["capacity cf 1.25"][0], want)
    log(f"  capacity cf {E_k:g} vs dense: max_row_rel_err {rel:.3e} (limit "
        f"{CAPACITY_ROW_REL:.0e}), bit-equal "
        f"{bool(torch.equal(exact[0], want))}; cf 1.25 vs dense "
        f"{rel125:.3e} (not bounded: it drops)")
    check(not any(exact[2]), f"capacity at cf {E_k:g} dropped {exact[2]}")
    check(rel <= CAPACITY_ROW_REL, f"capacity at cf {E_k:g} differs from "
          f"dense dispatch: row rel {rel:.3e}")
    check(all(torch.isfinite(r[0]).all().item() for r in runs.values()),
          "mixtral capacity: non-finite logits")
    return {label: r[1] for label, r in runs.items()}


def phase_mixtral_replicated(cfg, params, expert=3):
    """``replicate_expert`` on the card: expert ``expert`` replicated in
    every layer of the 4-layer bf16 mixtral's stacks (9 physical rows a
    layer), the owner/share the reference builds (owner ``[0..7,
    expert]``, share 1/2 on the expert's two rows, 1 elsewhere); then a
    prefill of 4 x 1024 tokens into the ring state and 8 teacher-forced
    decode steps through the kernels, whose logits must be within
    CAPACITY_ROW_REL per row of the unreplicated model's."""
    from repro_torch.models.api import build_model
    from repro_torch.models.moe import replicate_expert
    E = cfg.n_experts
    rep = dict(params, layers=dict(params["layers"]))
    rep["layers"]["moe"] = replicate_expert(params["layers"]["moe"], expert)
    moe = rep["layers"]["moe"]
    want_own = torch.tensor(list(range(E)) + [expert], dtype=torch.int32,
                            device="cuda").repeat(N_LAYERS, 1)
    want_sh = torch.ones((N_LAYERS, E + 1), device="cuda")
    want_sh[:, [expert, E]] = 0.5
    check(moe["w_gate"].shape[:2] == (N_LAYERS, E + 1)
          and torch.equal(moe["owner"], want_own)
          and torch.equal(moe["share"], want_sh),
          f"replicate_expert: owner {moe['owner'][0].tolist()}, share "
          f"{moe['share'][0].tolist()}")
    check(all(torch.equal(moe[n][:, E], moe[n][:, expert])
              for n in ("w_gate", "w_up", "w_down")),
          "replicate_expert: the replica's rows are not the expert's")
    model = build_model(cfg, use_kernel=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (RING_B, 1024), generator=gen,
                           device="cuda")
    outs = []
    for p in (params, rep):
        state = model.init_decode_state(p, RING_B, RING_PROMPT + RING_NEW)
        logits, state = model.prefill(p, state, tokens)
        seen = [logits]
        for t in range(8):
            nxt = outs[0][t].argmax(-1) if outs else logits.argmax(-1)
            logits, state = model.decode_step(p, state, nxt)
            seen.append(logits)
        outs.append(seen)
        del state
    rel = max(row_rel_err(a, b) for a, b in zip(*outs))
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    log(f"replicate_expert({expert}) in every layer of the {N_LAYERS}-layer "
        f"bf16 mixtral ({E + 1} physical rows a layer): prefill + 8 decode "
        f"steps max_row_rel_err {rel:.3e} (limit {CAPACITY_ROW_REL:.0e}) "
        f"against the unreplicated model, bit-equal {same}")
    check(rel <= CAPACITY_ROW_REL, f"replicated expert moves the logits: "
          f"row rel {rel:.3e}")
    check(all(torch.isfinite(t).all().item() for t in outs[1]),
          "replicated mixtral: non-finite logits")
    del rep, moe


def _lockstep_stream(model, params, tokens, steps):
    """Greedy lock-step decode: the prefill's logits, then ``steps``
    steps; returns the tokens and every step's logits."""
    state = model.init_decode_state(params, tokens.shape[0],
                                    tokens.shape[1] + steps)
    logits, state = model.prefill(params, state, tokens)
    seen, toks = [logits], []
    for _ in range(steps):
        toks.append(logits.argmax(-1))
        logits, state = model.decode_step(params, state, toks[-1])
        seen.append(logits)
    return torch.stack(toks, dim=1), seen


def phase_int8_weight_stream_pair():
    """float32, published widths, 4 layers, int8 weights
    (``int8_layerwise``): mixtral-8x7b with capacity dispatch (2 rows of
    4096 tokens into the ring: windowed flash, the ring kernel) and
    llama3-8b (4 rows of 512: flash, the resident kernel over identity
    rows), each with the kernels and without, through the lock-step API
    (the engines take no int8 weights, as the reference's): the greedy
    streams must be equal and every step's logits within
    STREAM_LOGIT_ATOL."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    for arch, B, S, kw in (("mixtral-8x7b", 2, RING_PROMPT,
                            dict(capacity_moe=True)),
                           ("llama3-8b", 4, 512, {})):
        cfg = get_config(arch).with_overrides(
            n_layers=N_LAYERS, dtype="float32", param_dtype="float32")
        params = int8_layerwise(cfg, "cuda", seed=1)
        # rpr: ignore[RPR001] -- this configuration's one input draw
        gen = torch.Generator(device="cuda").manual_seed(8)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device="cuda")
        runs = [_lockstep_stream(build_model(cfg, use_kernel=uk,
                                             device="cuda", **kw),
                                 params, tokens, 32)
                for uk in (True, False)]
        worst = max((a - b).abs().max().item()
                    for a, b in zip(runs[0][1], runs[1][1]))
        same = torch.equal(runs[0][0], runs[1][0])
        log(f"f32 int8-weight streams {arch} ({N_LAYERS} layers, {B} x {S} "
            f"tokens, 32 steps) kernels vs plain: streams "
            f"{'equal' if same else 'differ'}, max per-step logit "
            f"difference {worst:.3e} (limit {STREAM_LOGIT_ATOL:.0e})")
        check(same, f"{arch} int8 weights: greedy streams differ")
        check(worst <= STREAM_LOGIT_ATOL, f"{arch} int8 weights: logits "
              f"differ by {worst:.3e}")
        check(all(torch.isfinite(g).all().item() for r in runs for g in r[1]),
              f"{arch} int8 weights: non-finite logits")
        del params, runs
        release()


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
                 params=None, **kw):
    """``make_engine(mode="auto")`` for ``cfg``: 8 slots, λ = 8, four
    simulated devices, ``n_requests`` prompts of ``prompt`` tokens from
    the ``traffic`` helper; random weights from seed 0 unless ``params``
    are given; ``kw``: the engine's other arguments (``part``)."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import make_engine
    kw.setdefault("max_seq", prompt + max_new + 8)
    eng = make_engine(cfg, mode="auto", n_slots=RWKV_B, lam=8, seed=0,
                      net=DeviceNetwork.sample(4, seed=1),
                      use_kernel=use_kernel, params=params, device="cuda",
                      **kw)
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
# bucket, musicgen's largest bucket (MHA at dh 64), zamba2's lock-step wave
# (MHA at dh 80), and the tp-16 layouts' largest buckets (llama3-8b's 32
# heads over 16 KV rows, qwen1.5-32b's 48 padded heads)
FLASH_SHAPES = {
    "llama bucket": (1, 32, 8, 512, 0, 128),
    "mixtral wave": (RING_B, 32, 8, RING_PROMPT, RING_W, 128),
    "glm4": (1, 32, 2, GLM_HI, 0, 128),
    "musicgen bucket": (1, 32, 32, 512, 0, 64),
    "zamba2 wave": (ZAMBA_B, 32, 32, ZAMBA_PROMPT, 0, 80),
    "llama tp16 bucket": (1, 32, 16, 512, 0, 128),
    "qwen tp16 bucket": (1, 48, 48, 512, 0, 128),
}


def phase_flash_vs_plain():
    """The flash kernel against its plain version (the model's own prefill
    arithmetic: ``attention_scores`` below a KV extent of 2048,
    ``chunked_attention`` at 2048 and above) at the five paths' bf16
    shapes, a ragged S = 1000 under a window, a non-causal case, Sq < Skv,
    MHA at dh 128 (qwen1.5-32b's heads), dh 80 (zamba2's: non-causal and
    Sq < Skv too), and float32, with a fault planted at dh 80 that the
    bound must catch; then its times at the five shapes beside the plain
    version, SDPA and the bound.  The glm4 shape's go into the record."""
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
        ("zamba2 wave f32", f32, dict(B=ZAMBA_B, H=32, KvE=32,
                                      Sq=ZAMBA_PROMPT, dh=80), True, 0),
        ("zamba2 non-causal S=300", bf16, dict(B=1, H=32, KvE=32, Sq=300,
                                               dh=80), False, 0),
        ("zamba2 Sq=200 < Skv=700", bf16, dict(B=2, H=32, KvE=32, Sq=200,
                                               Skv=700, dh=80), True, 0),
        ("zamba2 Sq=200 < Skv=700 f32", f32, dict(B=2, H=32, KvE=32,
                                                  Sq=200, Skv=700, dh=80),
         True, 0),
    ]
    worst = worst_rel = 0.0
    planted = None
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
        if label == "zamba2 wave":
            # a body that drops the last of dh 80's five panels of V: the
            # output's columns 64-79 zero
            cut = want.clone()
            cut[..., 64:] = 0
            planted = row_rel_err(cut, want)
            log(f"  planted fault at dh 80 (V's last panel dropped): "
                f"max_row_rel_err={planted:.3e} (limit "
                f"{FLASH_ROW_REL[dt]:.0e})")
        del q, k, v, out, want
    check(planted is not None and planted > FLASH_ROW_REL[bf16],
          "the flash bound misses the dh 80 planted fault")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {}
    for label, (B, H, KvE, S, window, dh) in FLASH_SHAPES.items():
        # input copies together larger than the 50 MB L2, so every call
        # reads cold; long shapes are one copy and fewer timed calls
        small = S <= 1024
        sets = [flash_inputs(bf16, B=B, H=H, KvE=KvE, Sq=S, dh=dh,
                             seed=10 + c)
                for c in range((16 if B == 1 else 4) if small else 1)]
        kw = dict(causal=True, window=window)
        reps, n = (20, 50) if small else (2, 5)
        ms = cuda_ms([lambda a=a: flash_attention(*a, **kw) for a in sets],
                     reps=reps, n=n)
        # the plain version materializes the scores (1 GB at zamba2's
        # wave): fewer calls past one batch row
        plain_reps = (reps, n) if small and B == 1 else (4, 10) if small \
            else (1, 3)
        plain_ms = cuda_ms([lambda a=a: flash_attention_plain(*a, **kw)
                            for a in sets], *plain_reps)
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


def drive_auto_path(path, eng, max_new, per_step=None):
    """Drive a continuous-batching path built by ``auto_engine`` to idle
    with every kernel's count set to 0 just before, a straggler at step 16
    on the busiest device; log its host-clock split and peak memory, and
    check that every request finished, an interval applied head
    migrations, the flash kernel launched ``FLASH_LAUNCHES[path]`` times,
    each decode kernel of ``per_step`` ({kernel: launches a decode step};
    the resident kernel once a layer by default) that many times each
    decode step, and no other kernel; then time the drained batch's
    decode step as one CUDA graph.  Returns the launches of
    ``per_step``'s kernels, in its order, and the flash kernel's."""
    from repro_torch.serving.engine import ServingEngine
    cfg = eng.cfg
    per_step = per_step or {"decode_attention_resident": cfg.n_layers}
    check(isinstance(eng, ServingEngine),
          f"make_engine picked {type(eng).__name__} for {path}")
    weight_gb = sum(t.numel() * t.element_size() for t in
                    _leaves(eng.params)) / 1e9
    seen = watch_logits(eng)
    prefill = time_prefill(eng)
    reset_launches()
    t0 = time.monotonic()
    while drive(eng):
        pass
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    flash = launches.pop("flash_attention")
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
          f"{FLASH_LAUNCHES[path]} (16 prefills x its self-attention "
          f"layers)")
    want = {k: eng.decode_steps * n for k, n in per_step.items()}
    check({k: n for k, n in launches.items() if n} == want,
          f"{path}: decode kernel launches {launches} != decode steps "
          f"{eng.decode_steps} x {per_step}")
    check(bool(seen["finite"].item()), f"{path}: non-finite logits")
    graph_decode_step(eng)
    return (*want.values(), flash)


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


# --------------------------------------------------------- the VLM path
def vlm_images(n: int, d_model: int, seed: int = 0):
    """Image embeddings of ``n`` requests from ``default_rng(seed)``:
    request i holds ``VLM_IMG``, ``VLM_TILE`` or no rows (None), in
    turn."""
    rng = np.random.default_rng(seed)
    rows = (VLM_IMG, VLM_TILE, 0)
    return [rng.standard_normal((rows[i % 3], d_model), np.float32)
            if rows[i % 3] else None for i in range(n)]


def set_vlm_gates(params):
    """Every cross layer's attention gate to 0.7 and MLP gate to 0.5 (the
    reference's own VLM test's values), in place: the init leaves both at
    zero, where a cross layer adds nothing and a wrong cross-attention
    would pass every check."""
    params["cross_layers"]["attn"]["gate"].fill_(0.7)
    params["cross_layers"]["gate_ffn"].fill_(0.5)


def vlm_engine(cfg, *, use_kernel, n_requests, max_new, params=None):
    """``make_engine(mode="auto")`` for the VLM on the dense path's shape
    (8 slots, an extent of 1024, λ = 8, four simulated devices) with image
    buffers of ``VLM_IMG`` rows and the "columns" layout (one plan for
    every layer: it applies to the supergroup stacks, the cross layers and
    the image K/V); the dense path's prompts, each with its image of
    ``vlm_images``.  Weights drawn here get the gates of
    ``set_vlm_gates``."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import make_engine
    eng = make_engine(cfg, mode="auto", n_slots=MAIN_B, max_seq=MAIN_T,
                      lam=8, seed=0, net=DeviceNetwork.sample(4, seed=1),
                      use_kernel=use_kernel, params=params, device="cuda",
                      img_tokens=VLM_IMG, layer_mode="columns")
    if params is None:
        set_vlm_gates(eng.params)
    for p, img in zip(traffic(n_requests, cfg.vocab_size),
                      vlm_images(n_requests, cfg.d_model)):
        eng.submit(p, max_new_tokens=max_new, img_embeds=img)
    return eng


def phase_vlm_path():
    """Serve the dense path's traffic (16 requests of 32-512 tokens, 64 new
    tokens each) on the full-width llama-3.2-vision-11b cut to 2
    supergroups (8 self + 2 gated cross layers) through
    ``make_engine(mode="auto")``, which must pick the continuous engine;
    requests carry a 1601-row image, a 1025-row one or none, in turn.
    Every bucketed prefill runs the flash kernel once a self layer, every
    decode step the resident kernel once a layer (self layers over the
    cache with identity rows, cross layers over the image K/V with
    lengths 1601, 1025 or 0 from the masks), and a straggler at step 16
    on the busiest device makes an interval apply head migrations to the
    weights, the cache and the image K/V.  Returns the decode kernel's
    and the flash kernel's launches."""
    from repro_torch.configs import get_config
    cfg = get_config("llama-3.2-vision-11b").with_overrides(
        n_layers=VLM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = vlm_engine(cfg, use_kernel=True, n_requests=16, max_new=64)
    log(f"vlm weights: random from seed 0, then every cross layer's gate "
        f"0.7 and gate_ffn 0.5 (the init leaves them at zero); images "
        f"N(0, 1) from seed 0 of {VLM_IMG}, {VLM_TILE} and 0 rows in turn, "
        f"in a {VLM_IMG}-row buffer a slot")
    return drive_auto_path("vlm", eng, 64)


def phase_vlm_stream_pair():
    """float32, one supergroup (5 layers), gated: the VLM path with the
    kernels (flash prefill, the resident decode kernel's CUDA-core body
    over the cache and over the 1601-row image K/V with lengths from the
    masks) and without, from the same weights, 8 requests of 32-512
    tokens with their images and a straggler at step 8, must stream the
    same greedy tokens with the same migration logs.  An image must move
    its request's logits: each imaged request's first logits, from a
    prefill with its image and one without, differ by more than 1e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("llama-3.2-vision-11b").with_overrides(
        n_layers=5, dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    set_vlm_gates(params)
    engines = [vlm_engine(cfg, use_kernel=uk, n_requests=8, max_new=32,
                          params=params) for uk in (True, False)]
    stream_pair("vlm kernels vs plain (5 layers)", engines)
    eng = engines[0]
    moved = []
    for r in eng.finished:
        if not r.img_mask.any():
            continue
        with_img, _ = eng._prefill_dense(0, r)
        blind = dataclasses.replace(r, img=None, img_mask=None)
        without, _ = eng._prefill_dense(0, blind)
        moved.append((with_img - without).abs().max().item())
    log(f"vlm image effect: max |first logits with image - without| per "
        f"imaged request {[f'{m:.3e}' for m in moved]}")
    check(moved and min(moved) > 1e-2, "an image did not move its "
          "request's logits")
    del engines, eng, params


def phase_vlm_int8_path():
    """The VLM path (``phase_vlm_path``'s traffic, weights and images)
    from an int8 cache (``kv_quant``: the self layers' (G, 4, ...) values
    int8 with float32 per-(token, head) scales; the image K/V stays bf16):
    every decode step runs ``decode_attention_int8_resident`` once a self
    layer and the resident kernel once a cross layer, every bucketed
    prefill flash once a self layer over the dequantized rows, and an
    interval applies head migrations to the values, their scales and the
    image K/V (``drive_auto_path``).  Returns the int8 kernel's, the
    resident kernel's and the flash kernel's launches."""
    from repro_torch.configs import get_config
    cfg = get_config("llama-3.2-vision-11b").with_overrides(
        n_layers=VLM_LAYERS, kv_quant=True)
    torch.cuda.reset_peak_memory_stats()
    eng = vlm_engine(cfg, use_kernel=True, n_requests=16, max_new=64)
    check(eng.state["cache"]["k"].dtype == torch.int8,
          "vlm int8: the cache is not int8")
    return drive_auto_path("vlm int8", eng, 64, per_step={
        "decode_attention_int8_resident": VLM_SELF,
        "decode_attention_resident": VLM_LAYERS - VLM_SELF})


def phase_vlm_int8_stream_pair():
    """float32, one supergroup (5 layers), gated, int8 cache: the VLM
    path with the kernels (the int8 kernel's CUDA-core body over the self
    layers' int8 values and scales, the resident kernel over the 1601-row
    image K/V) and without (the dequantized cache through plain
    attention), from the same weights, 8 requests of 32-512 tokens with
    their images and a straggler at step 8, must stream the same greedy
    tokens with the same migration logs (``stream_pair``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("llama-3.2-vision-11b").with_overrides(
        n_layers=5, dtype="float32", param_dtype="float32", kv_quant=True)
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    set_vlm_gates(params)
    engines = [vlm_engine(cfg, use_kernel=uk, n_requests=8, max_new=32,
                          params=params) for uk in (True, False)]
    check(engines[0].state["cache"]["k"].dtype == torch.int8,
          "vlm int8 pair: the cache is not int8")
    stream_pair("vlm int8 kernels vs plain (5 layers)", engines)
    del engines, params


# ------------------------------------------------------- the zamba2 path
def seed_ssm_params(params, seed=0):
    """Set every mamba layer's ``conv_b`` (0.3 N), ``A_log`` (evenly over
    [-6, 3] across all SSM heads, shuffled: decays exp(-exp(A_log) dt)
    from near 1 to near 0), ``dt_bias`` (0.5 N) and ``D`` (1 + 0.5 N) in
    place from a seeded generator: the init leaves them at 0, 0, 0 and 1,
    which would hide a wrong conv bias, decay or skip."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lay = params["layers"]

    def normal(t):
        return torch.randn(t.shape, generator=gen, device="cuda")

    n = lay["A_log"].numel()
    spread = torch.linspace(-6.0, 3.0, n, device="cuda")
    lay["A_log"].copy_(spread[torch.randperm(n, generator=gen,
                                             device="cuda")].view_as(
        lay["A_log"]))
    lay["conv_b"].copy_(0.3 * normal(lay["conv_b"]))
    lay["dt_bias"].copy_(0.5 * normal(lay["dt_bias"]))
    lay["D"].copy_(1.0 + 0.5 * normal(lay["D"]))


def zamba2_cfg(n_layers=ZAMBA_LAYERS, **over):
    from repro_torch.configs import get_config
    return get_config("zamba2-2.7b").with_overrides(n_layers=n_layers,
                                                    **over)


def zamba2_engine(cfg, *, use_kernel, n_requests, prompt, max_new,
                  params=None, max_seq=ZAMBA_MAX_SEQ, **kw):
    """``make_engine(mode="auto")`` for zamba2: 8 slots, λ = 8, four
    simulated devices, the "columns" layout (as the VLM path: per-layer
    plans of a graph layout cost hundreds of ms an interval and, like
    every plan, cannot apply to a hybrid state), ``n_requests`` prompts
    of ``prompt`` tokens; random weights from seed 0, then
    ``seed_ssm_params``, unless ``params`` are given; ``kw``: the
    engine's other arguments (``part``)."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import make_engine
    eng = make_engine(cfg, mode="auto", n_slots=ZAMBA_B, max_seq=max_seq,
                      lam=8, seed=0, net=DeviceNetwork.sample(4, seed=1),
                      use_kernel=use_kernel, params=params, device="cuda",
                      layer_mode="columns", **kw)
    if params is None:
        seed_ssm_params(eng.params)
    for p in traffic(n_requests, cfg.vocab_size, length=prompt):
        eng.submit(p, max_new_tokens=max_new)
    return eng


def time_ssd_scan():
    """Wrap the Mamba-2 block's ``ssd_scan`` in a host clock between device
    syncs, for calls over more than one token (prefill); returns {"s":
    seconds so far, "calls": count}.  Undo with ``untime_ssd_scan``."""
    from repro_torch.models import mamba2
    spent = {"s": 0.0, "calls": 0, "inner": mamba2.ssd_scan}

    def timed(xh, *a):
        if xh.shape[1] == 1:
            return spent["inner"](xh, *a)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = spent["inner"](xh, *a)
        torch.cuda.synchronize()
        spent["s"] += time.monotonic() - t0
        spent["calls"] += 1
        return out

    mamba2.ssd_scan = timed
    return spent


def untime_ssd_scan(spent):
    from repro_torch.models import mamba2
    mamba2.ssd_scan = spent["inner"]


def graph_wave_step(model, params, prompt, max_seq):
    """A lock-step batch of ``ZAMBA_B`` rows prefilled with ``prompt``
    tokens, then its decode step captured in a CUDA graph and replayed
    (``cuda_ms``): the device's own time for a step, host launches
    removed (the model's own methods: the engine's hooks are not
    captured).  Returns ms."""
    cls = type(model)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, model.cfg.vocab_size, (ZAMBA_B, prompt),
                           generator=gen, device="cuda")
    state = model.init_decode_state(params, ZAMBA_B, max_seq)
    _, state = cls.prefill(model, params, state, tokens)
    nxt = tokens[:, -1].clone()
    ms = cuda_ms([lambda: cls.decode_step(model, params, state, nxt)],
                 reps=5, n=20)
    del state
    return ms


def phase_zamba2_path():
    """Serve 16 requests (1024-token prompts, 64 new tokens each, two
    waves of 8) on the full-width zamba2-2.7b cut to 2 of its 9
    supergroups (12 mamba layers, the shared attention block every 6)
    through ``make_engine(mode="auto")``, which must pick the wave
    scheduler.  Each wave's prefill runs the flash kernel once a
    supergroup (B 8, 32 heads of 80), each decode step the resident
    kernel once a supergroup (identity rows, G 1); the Mamba-2 layers run
    plain torch.  A straggler at step 16 makes the controller plan head
    moves, which the engine logs as not applied (a hybrid state has no
    addressable KV cache) and which move nothing.  Returns the resident
    and flash kernels' launches."""
    from repro_torch.serving.engine import WaveServingEngine
    cfg = zamba2_cfg()
    torch.cuda.reset_peak_memory_stats()
    eng = zamba2_engine(cfg, use_kernel=True, n_requests=16,
                        prompt=ZAMBA_PROMPT, max_new=ZAMBA_NEW)
    check(isinstance(eng, WaveServingEngine),
          f"make_engine picked {type(eng).__name__} for zamba2")
    log("zamba2 weights: random from seed 0, then every mamba layer's "
        "conv_b, A_log (spread over [-6, 3]), dt_bias and D set from seed 0 "
        "(the init leaves them at 0, 0, 0 and 1); the \"columns\" layout: "
        "no plan applies to a hybrid state, and a graph layout's intervals "
        "cost hundreds of ms")
    weight_gb = sum(t.numel() * t.element_size() for t in
                    _leaves(eng.params)) / 1e9
    shared = [t.clone() for t in _leaves(eng.params["shared"])]
    fired = head_straggler(eng, 16)
    seen = watch_logits(eng)
    prefill = time_prefill(eng)
    scan = time_ssd_scan()
    reset_launches()
    # the weights' init draws each stack in float32 before casting: its
    # peak is logged apart from the run's
    init_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        eng.run()
    finally:
        untime_ssd_scan(scan)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    resident = launches.pop("decode_attention_resident")
    flash = launches.pop("flash_attention")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = sum(len(r.out_tokens) for r in eng.finished)
    planned = [e for e in eng.migration_log if e["n_migrations"]]
    hd = eng.model.hd
    cache_mb = 2 * ZAMBA_GROUPS * ZAMBA_B * ZAMBA_MAX_SEQ * hd.KvE * hd.dh \
        * 2 / 1e6
    ssm_mb = ZAMBA_LAYERS * ZAMBA_B * 80 * 64 * 64 * 4 / 1e6
    log(f"main path zamba2 (make_engine auto -> {type(eng).__name__}) bf16 "
        f"zamba2-2.7b x{ZAMBA_LAYERS} mamba layers, {ZAMBA_GROUPS} "
        f"supergroups: {len(eng.finished)} requests, {tokens} tokens, "
        f"{eng.decode_steps} decode steps in {wall:.2f} s "
        f"({tokens / wall:.1f} tok/s); decode step median "
        f"{1e3 * float(np.median(eng.step_times)):.2f} ms; "
        f"{len(eng.interval_times)} controller intervals, mean "
        f"{1e3 * float(np.mean(eng.interval_times)):.1f} ms; straggler at "
        f"step {fired}; decode_attention_resident {resident}, "
        f"flash_attention {flash}, others {launches}")
    log_split(eng, wall, prefill)
    log(f"  controller: {sum(e['n_migrations'] for e in planned)} head "
        f"migrations planned in {len(planned)} intervals (priced at "
        f"{sum(e['mig_bytes'] for e in planned) / 1e6:.1f} MB, as the "
        f"reference prices them), none applied ({NO_CACHE!r}): 0 bytes "
        f"moved, the shared block's weights unchanged")
    log(f"  prefill: the SSD scan's token loop {scan['s']:.2f} s of "
        f"{prefill['s']:.2f} s ({scan['calls']} calls, "
        f"{100 * scan['s'] / prefill['s']:.1f} %)")
    log(f"  memory: weights {weight_gb:.2f} GB, attention cache "
        f"{cache_mb:.1f} MB, SSM state {ssm_mb:.1f} MB a wave; peak "
        f"allocated {peak_gb:.2f} GB serving ({init_gb:.2f} GB while the "
        f"weights were drawn)")
    check(len(eng.finished) == 16 and all(len(r.out_tokens) == ZAMBA_NEW
                                          for r in eng.finished),
          "zamba2: not every request finished with its tokens")
    check(eng.decode_steps == 2 * (ZAMBA_NEW - 1),
          f"zamba2: {eng.decode_steps} decode steps != 2 waves x "
          f"{ZAMBA_NEW - 1}")
    check(resident == eng.decode_steps * ZAMBA_GROUPS,
          f"zamba2: resident launches {resident} != decode steps "
          f"{eng.decode_steps} x {ZAMBA_GROUPS} supergroups")
    check(flash == FLASH_LAUNCHES["zamba2"],
          f"zamba2: flash launches {flash} != 2 waves x {ZAMBA_GROUPS}")
    check(not any(launches.values()),
          f"zamba2: another kernel launched: {launches}")
    check(bool(planned), "zamba2: the controller planned no head move")
    check(all(not e["applied"] for e in eng.migration_log)
          and all(e["reason"] == NO_CACHE for e in planned),
          "zamba2: an interval was logged as applied, or without the "
          "reference's reason")
    check(all(torch.equal(a, b) for a, b in
              zip(_leaves(eng.params["shared"]), shared)),
          "zamba2: a plan permuted the shared block's weights")
    check(bool(seen["finite"].item()), "zamba2: non-finite logits")
    del shared
    graph_ms = graph_wave_step(eng.model, eng.params, ZAMBA_PROMPT,
                               ZAMBA_MAX_SEQ)
    eager_ms = 1e3 * float(np.median(eng.step_times))
    log(f"  decode step as one CUDA graph: {graph_ms:.3f} ms of device work "
        f"against the eager median {eager_ms:.2f} ms (the device idle "
        f"{100 * (1 - graph_ms / eager_ms):.1f} % of an eager step)")
    return resident, flash


def phase_zamba2_full_depth():
    """The whole 54-layer zamba2-2.7b (9 supergroups: one shared block over
    nine cache slots), no engine: prefill 8 x 1024 tokens and decode 16
    steps through both kernels.  Flash launches once a supergroup in the
    prefill, the resident kernel once a supergroup a step; the logits are
    finite."""
    from repro_torch.models.api import build_model
    cfg = zamba2_cfg(54)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, use_kernel=True, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    seed_ssm_params(params)
    weight_gb = sum(t.numel() * t.element_size() for t in
                    _leaves(params)) / 1e9
    # the init draws each stack in float32 before casting (5.8 GB for the
    # 54 layers' w_in): its peak is logged apart from the run's
    init_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (ZAMBA_B, ZAMBA_PROMPT),
                           generator=gen, device="cuda")
    state = model.init_decode_state(params, ZAMBA_B, ZAMBA_MAX_SEQ)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, state = model.prefill(params, state, tokens)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    finite = torch.isfinite(logits).all()
    steps = []
    for _ in range(16):
        t0 = time.monotonic()
        logits, state = model.decode_step(params, state,
                                          logits.argmax(-1))
        torch.cuda.synchronize()
        steps.append(time.monotonic() - t0)
        finite &= torch.isfinite(logits).all()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"zamba2 full depth (54 mamba layers, {model.n_groups} "
        f"supergroups, bf16): weights {weight_gb:.2f} GB, peak allocated "
        f"{peak_gb:.2f} GB prefilling and decoding ({init_gb:.2f} GB while "
        f"the weights were drawn); prefill {ZAMBA_B} x {ZAMBA_PROMPT} tokens "
        f"{prefill_s:.2f} s; decode step median "
        f"{1e3 * float(np.median(steps)):.2f} ms over 16 steps; "
        f"flash_attention {launches['flash_attention']}, "
        f"decode_attention_resident "
        f"{launches['decode_attention_resident']}")
    check(model.n_groups == 9, "zamba2: the full model is not 9 supergroups")
    check(launches["flash_attention"] == model.n_groups
          and launches["decode_attention_resident"] == 16 * model.n_groups,
          f"zamba2 full depth: launches {launches} != 9 flash and 16 x 9 "
          f"resident")
    check(bool(finite.item()), "zamba2 full depth: non-finite logits")
    del model, params, state, logits


def phase_zamba2_stream_pair():
    """float32, full widths, the reference's own hybrid reduction of depth
    (4 mamba layers, the shared block every 2: 2 supergroups), seeded SSM
    parameters: the zamba2 path with the kernels (flash's CUDA-core body
    and the resident kernel's CUDA-core body at dh 80, G 1) and without,
    from the same weights, 8 requests of 64 tokens and a straggler at step
    8, must stream the same greedy tokens with the same logs (plans
    logged, none applied)."""
    from repro_torch.models.api import build_model
    cfg = zamba2_cfg(4, shared_attn_every=2, dtype="float32",
                     param_dtype="float32")
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    seed_ssm_params(params)
    keys = ("step", "n_migrations", "mig_bytes", "applied", "reason")
    runs = []
    for use_kernel in (True, False):
        eng = zamba2_engine(cfg, use_kernel=use_kernel, n_requests=8,
                            prompt=64, max_new=24, params=params,
                            max_seq=96)
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
    log(f"f32 streams zamba2 kernels vs plain (4 mamba layers, 2 "
        f"supergroups): {len(s0)} requests, max per-step logit difference "
        f"{worst:.3e}, {sum(m[1] for m in l0)} head migrations planned "
        f"(none applied), logs {'equal' if l0 == l1 else 'differ'}")
    check(len(s0) == 8 and s0 == s1, "zamba2: greedy streams differ")
    check(l0 == l1, "zamba2: migration logs differ")
    check(any(m[1] and not m[3] and m[4] == NO_CACHE for m in l0),
          "zamba2: no head move was planned and logged as not applied")
    check(all(torch.isfinite(g).all().item() for g in g0 + g1),
          "zamba2: non-finite logits")
    del params


# ---------------------------------------------------- the pipelined paths
# pipeline_k = 2: the dense path's 8 slots in 2 groups of 4, one group
# decoded a scheduler step, the controller's plans from the bottleneck
# search every λ·K = 16 steps.  Paged: pages of 64, 24 a group (48 in all,
# as the paged path).  24 new tokens a request (the sequential paths' 64):
# 90-91 % of these paths' wall is the host's bottleneck search at each
# interval, so fewer tokens mean fewer intervals and a shorter wall, while
# the run still straddles the straggler at step 16 with applied plans.
PIPE_K = 2
PIPE_NEW = 24
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
    """Serve the dense path's prompts (16 requests of 32-512 tokens,
    ``PIPE_NEW`` new tokens each, a 500x straggler at step 16 on the
    busiest device) with
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
    eng = serve(cfg, use_kernel=True, n_requests=16, max_new=PIPE_NEW,
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
    check(len(eng.finished) == 16 and all(len(r.out_tokens) == PIPE_NEW
                                          for r in eng.finished),
          f"pipelined {path}: not every request finished with its "
          f"{PIPE_NEW} tokens")
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


# ------------------------------------------------------------- training
# Training runs the plain torch path (the kernels have no backward, as the
# reference's Pallas kernels have no VJP); the trained weights are then
# served through the flash and resident decode kernels.
#
# The train parity phase: the CPU tests' reduced float32 widths
# (``repro_torch.configs.reduced``) of four families, one train step on
# the card against the same step on the CPU from the same weights.  Adam's
# first step moves each weight by about lr * sign(g): a gradient element
# within rounding of zero may take either sign on the two devices, so the
# step's lr is small enough (1e-5) that such a flip stays inside the
# bound on the smallest leaf (the 0.02-scale embedding table).
TRAIN_PARITY = ("llama3-8b", "mixtral-8x7b", "rwkv6-7b", "zamba2-2.7b")
TRAIN_PARITY_LR = 1e-5
TRAIN_PARITY_REL = 1e-4      # of each leaf's largest magnitude
# paper-gpt at its published config through launch.train: B 8 x S 512,
# 300 steps, a checkpoint every 150.  The mean loss of steps 291-300 must
# sit at least PAPER_LOSS_DROP nats below that of steps 1-10 (which start
# near ln 50257 = 10.8; stated before the first run, PERF.md).
PAPER_B, PAPER_S, PAPER_STEPS, PAPER_EVERY = 8, 512, 300, 150
PAPER_LOSS_DROP = 1.0
# the trained weights served greedily: 8 prompts of 512 tokens from a
# held-out stream, 64 steps through the lock-step API
SERVE_B, SERVE_S, SERVE_STEPS = 8, 512, 64
# one train step at llama3-8b's published widths, 4 layers, bf16
FULL_B, FULL_S, FULL_STEPS = 4, 512, 10
# what the AdamW update must move per parameter: read the bf16 param and
# grad and the f32 moments, write the param and the moments
UPDATE_BYTES_PER_PARAM = 2 + 2 + 4 + 4 + 2 + 4 + 4


def _tree_rel_err(got, want) -> float:
    """The worst leaf's max |got - want| over its largest |want|."""
    from repro_torch.optim.adamw import tree_leaves
    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().cpu().float(), w.detach().cpu().float()
        scale = max(w.abs().max().item(), 1e-30)
        worst = max(worst, (g - w).abs().max().item() / scale)
    return worst


def phase_train_parity():
    """One train step (``launch.steps.make_train_step``: autograd through
    ``model.loss``, then ``AdamW.update``) of each reduced float32 family
    on the card and on the CPU from the same weights and batch: the loss,
    the gradients and the updated params within TRAIN_PARITY_REL of each
    leaf's largest magnitude.  rwkv6's ``u``/``lora_B``/``lw_B`` and
    zamba2's SSM parameters are seeded nonzero first; mixtral's loss
    carries its MoE aux loss."""
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW, tree_map
    from repro_torch.weights import params_from_jax
    opt = AdamW(lr=TRAIN_PARITY_LR)
    for arch in TRAIN_PARITY:
        cfg = reduced_config(arch)
        params = build_model(cfg, device="cuda").init(
            # rpr: ignore[RPR001] -- another model's weights, from seed 0
            torch.Generator(device="cuda").manual_seed(0))
        if arch == "rwkv6-7b":
            nonzero_adapters(params)
        if arch == "zamba2-2.7b":
            seed_ssm_params(params)
        host = tree_map(lambda t: t.cpu().numpy(), params)
        toks = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, 17)).astype(np.int32)
        out = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, device=dev)
            p = params_from_jax(host, dev)
            batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                     "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
            _, grads = value_and_grad(model.loss, p, batch)
            new_p, _, loss = make_train_step(model, opt)(p, opt.init(p),
                                                         batch)
            out[dev] = (loss.item(), grads, new_p)
        loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        grad_err = _tree_rel_err(out["cuda"][1], out["cpu"][1])
        param_err = _tree_rel_err(out["cuda"][2], out["cpu"][2])
        log(f"train parity {arch} (reduced f32): loss card "
            f"{out['cuda'][0]:.6f} cpu {out['cpu'][0]:.6f} (rel "
            f"{loss_err:.2e}); worst leaf grads {grad_err:.2e}, params "
            f"after one step {param_err:.2e} (limit {TRAIN_PARITY_REL:.0e})")
        for what, err in (("loss", loss_err), ("grads", grad_err),
                          ("params", param_err)):
            check(err <= TRAIN_PARITY_REL, f"train parity {arch}: {what} "
                  f"differ by {err:.2e} of their scale")
        release()


def time_train_split(model, opt, params, batch, n: int):
    """``n`` steps on one batch, each split by device syncs into autograd
    through ``model.loss`` and the AdamW update (host clock); returns the
    losses and the per-step seconds of each part."""
    from repro_torch.launch.steps import value_and_grad
    state = opt.init(params)
    losses, fb, upd = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(model.loss, params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            params, state = opt.update(grads, state, params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del grads
        losses.append(loss.item())
        fb.append(t1 - t0)
        upd.append(t2 - t1)
    return losses, fb, upd


def log_train_split(label, cfg, B, S, fb, upd):
    """The median step's split (first step left out: allocation and
    library warm-up), its FLOPs over time (6 N per token) and the
    update's bytes over time, each beside its floor at the card's
    peaks."""
    n_params = cfg.param_count()
    fb_ms, up_ms = 1e3 * float(np.median(fb[1:])), \
        1e3 * float(np.median(upd[1:]))
    flops = 6 * n_params * B * S
    upd_bytes = UPDATE_BYTES_PER_PARAM * n_params
    log(f"  {label} step split (median of {len(fb) - 1} after the first): "
        f"forward+backward {fb_ms:.2f} ms, AdamW update {up_ms:.2f} ms, "
        f"step {fb_ms + up_ms:.2f} ms")
    log(f"  {label}: 6 N tokens = {flops:.3e} FLOP in {fb_ms:.2f} ms = "
        f"{flops / fb_ms / 1e9:.1f} TFLOP/s (floor at the bf16 peak "
        f"{1e3 * flops / PEAK_FLOPS[torch.bfloat16]:.2f} ms); update "
        f"{upd_bytes / 1e9:.2f} GB at {UPDATE_BYTES_PER_PARAM} B/param in "
        f"{up_ms:.2f} ms = {upd_bytes / up_ms / 1e9:.2f} TB/s (floor "
        f"{1e3 * upd_bytes / PEAK_BYTES_PER_S:.2f} ms)")


def _train_steps(record):
    return [r for r in record if "loss" in r]


def phase_train_paper_gpt():
    """``launch.train.main`` on paper-gpt at its published config (1
    layer, d 2048, 32 heads of 64, d_ff 8192, vocab 50257, bf16): 300
    steps of B 8 x S 512 on the synthetic Zipf stream, a checkpoint every
    150 (2.73 GB: bf16 params, f32 moments), the loss falling by
    PAPER_LOSS_DROP.  Then the uninterrupted run's step-300 checkpoint is
    set aside and a second ``main`` resumes from step 150 to 300: its
    losses and its step-300 checkpoint (every leaf's sha1) must equal the
    first run's.  No kernel launches: training runs the plain path.
    Returns the trained params (bf16, on the card)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    cfg = get_config("paper-gpt")
    tmp = Path(tempfile.mkdtemp(prefix="paper_gpt_ckpt_"))
    argv = ["--arch", "paper-gpt", "--steps", str(PAPER_STEPS), "--batch",
            str(PAPER_B), "--seq", str(PAPER_S), "--ckpt", str(tmp),
            "--ckpt-every", str(PAPER_EVERY), "--log-every", "50"]
    last = f"step_{PAPER_STEPS:08d}"
    try:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        rec_a = []
        t0 = time.monotonic()
        train.main(argv, record=rec_a)
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = read_launches()
        steps_a = _train_steps(rec_a)
        losses = [r["loss"] for r in steps_a]
        first, final = float(np.mean(losses[:10])), \
            float(np.mean(losses[-10:]))
        step_s = float(np.median([r["seconds"] for r in steps_a[1:]]))
        saves = [r for r in rec_a if r.get("op") == "save"]
        log(f"train paper-gpt ({cfg.param_count():,} params, "
            f"{DTYPE_NAMES[cfg.param_dtype]}, B "
            f"{PAPER_B} x S {PAPER_S}): {len(steps_a)} steps in {wall:.1f} "
            f"s; loss {losses[0]:.4f} at step 1, mean of steps 1-10 "
            f"{first:.4f}, of steps {PAPER_STEPS - 9}-{PAPER_STEPS} "
            f"{final:.4f} (drop {first - final:.4f}, limit "
            f"{PAPER_LOSS_DROP}); median step {1e3 * step_s:.2f} ms, "
            f"{PAPER_B * PAPER_S / step_s:.0f} tok/s; peak memory "
            f"{peak / 1e9:.2f} GB; kernel launches {launches}")
        for r in saves:
            log(f"  checkpoint step {r['step']}: {r['bytes']:,} bytes, "
                f"saved in {r['seconds']:.2f} s (copy to host, write, "
                f"sha1)")
        check(len(steps_a) == PAPER_STEPS, "paper-gpt: not every step ran")
        check(all(math.isfinite(x) for x in losses),
              "paper-gpt: a non-finite loss")
        check(first - final >= PAPER_LOSS_DROP, f"paper-gpt: the loss fell "
              f"by {first - final:.4f} < {PAPER_LOSS_DROP}")
        check(not any(launches.values()), f"training launched a kernel: "
              f"{launches}")
        manifest = json.loads((tmp / last / "manifest.json").read_text())
        shutil.rmtree(tmp / last)
        rec_b = []
        train.main(argv + ["--resume"], record=rec_b)
        steps_b = _train_steps(rec_b)
        restores = [r for r in rec_b if r.get("op") == "restore"]
        resumed = json.loads((tmp / last / "manifest.json").read_text())
        differ = [k for k, m in manifest["leaves"].items()
                  if resumed["leaves"][k]["sha1"] != m["sha1"]]
        gaps = [abs(a["loss"] - b["loss"])
                for a, b in zip(steps_a[PAPER_EVERY:], steps_b)]
        log(f"  resume from step {PAPER_EVERY}: restored "
            f"{restores[0]['bytes']:,} bytes in {restores[0]['seconds']:.2f}"
            f" s (read, sha1, to the card); steps "
            f"{steps_b[0]['step']}-{steps_b[-1]['step']}: largest loss gap "
            f"to the uninterrupted run {max(gaps):.3e}; step-"
            f"{PAPER_STEPS} checkpoint leaves whose sha1 differ: "
            f"{len(differ)} of {len(manifest['leaves'])}")
        check([r["step"] for r in steps_b]
              == list(range(PAPER_EVERY + 1, PAPER_STEPS + 1)),
              "paper-gpt resume: wrong steps")
        check(max(gaps) == 0.0, f"paper-gpt resume: losses differ from the "
              f"uninterrupted run by up to {max(gaps):.3e}")
        check(not differ, f"paper-gpt resume: {len(differ)} leaves differ "
              f"from the uninterrupted run: {differ[:4]}")
        model = build_model(cfg, device="cuda")
        like = model.init(torch.Generator(device="cuda").manual_seed(0))
        trained = Checkpointer(tmp).restore(PAPER_STEPS,
                                            {"params": like})["params"]
        del like
        release()
        # the step's split at the same shapes, on fresh weights
        src = iter(SyntheticLM(cfg.vocab_size, PAPER_S, PAPER_B))
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(src).items()}
        params = model.init(torch.Generator(device="cuda").manual_seed(1))
        _, fb, upd = time_train_split(
            model, AdamW(lr=cosine_schedule(3e-4, 20, PAPER_STEPS)), params,
            batch, FULL_STEPS)
        log_train_split("paper-gpt", cfg, PAPER_B, PAPER_S, fb, upd)
        del params
        return trained
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_train_then_serve(trained):
    """The trained paper-gpt weights serve greedily.  Cast to float32, 8
    held-out prompts of 512 tokens run through ``prefill`` and 64
    ``decode_step``s (as the quickstart generates) with the kernels —
    flash at H == KvE 32, dh 64; the resident decode kernel at G 1 — and
    without: the streams must be equal, every step's logits within
    STREAM_LOGIT_ATOL, and the kernel run's launches exact (flash once,
    the resident kernel once a step).  Then ``ServingEngine(use_kernel=
    True)`` serves the dense path's traffic on the trained bf16 weights
    to its end.  Returns each kernel's launches over both runs."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import tree_map
    cfg = get_config("paper-gpt")
    cfg32 = cfg.with_overrides(dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float(), trained)
    prompts = next(iter(SyntheticLM(cfg.vocab_size, SERVE_S, SERVE_B,
                                    seed=1)))
    tokens = torch.from_numpy(prompts["tokens"]).cuda()
    reset_launches()
    with torch.no_grad():
        kern = _lockstep_stream(build_model(cfg32, use_kernel=True,
                                            device="cuda"),
                                p32, tokens, SERVE_STEPS)
        launches = read_launches()
        plain = _lockstep_stream(build_model(cfg32, device="cuda"), p32,
                                 tokens, SERVE_STEPS)
        random = build_model(cfg32, device="cuda").init(
            torch.Generator(device="cuda").manual_seed(0))
        untrained = _lockstep_stream(build_model(cfg32, device="cuda"),
                                     random, tokens, 1)
    del random
    check(read_launches() == launches, "the plain stream launched a kernel")
    worst = max((a - b).abs().max().item() for a, b in zip(kern[1], plain[1]))
    same = torch.equal(kern[0], plain[0])

    def top1(logits):
        return torch.softmax(logits, -1).max(-1).values.mean().item()

    log(f"serve trained paper-gpt f32 ({SERVE_B} x {SERVE_S} prompts, "
        f"{SERVE_STEPS} steps) kernels vs plain: streams "
        f"{'equal' if same else 'differ'}, max per-step logit difference "
        f"{worst:.3e} (limit {STREAM_LOGIT_ATOL:.0e}); mean top-1 "
        f"probability of the first step {top1(kern[1][0]):.4f} trained, "
        f"{top1(untrained[1][0]):.6f} on random weights; launches "
        f"{launches}")
    check(same, "trained paper-gpt: greedy streams differ")
    check(worst <= STREAM_LOGIT_ATOL, f"trained paper-gpt: logits differ "
          f"by {worst:.3e}")
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.n_layers
    want["decode_attention_resident"] = SERVE_STEPS * cfg.n_layers
    check(launches == want, f"trained paper-gpt launches {launches} != "
          f"{want}")
    del p32, kern, plain
    release()
    reset_launches()
    eng = serve(cfg, use_kernel=True, n_requests=16, max_new=64,
                params=trained)
    seen = watch_logits(eng)
    t0 = time.monotonic()
    with torch.no_grad():
        while drive(eng):
            pass
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    served = read_launches()
    tokens_out = sum(len(r.out_tokens) for r in eng.finished)
    log(f"  ServingEngine(use_kernel=True) on the trained bf16 weights: "
        f"{len(eng.finished)} requests, {tokens_out} tokens, "
        f"{eng.decode_steps} decode steps in {wall:.2f} s; launches "
        f"{served}")
    check(len(eng.finished) == 16 and all(len(r.out_tokens) == 64
                                          for r in eng.finished),
          "trained paper-gpt engine: not every request finished")
    check(served["decode_attention_resident"]
          == eng.decode_steps * cfg.n_layers,
          f"trained paper-gpt engine: resident launches "
          f"{served['decode_attention_resident']} != decode steps "
          f"{eng.decode_steps} x {cfg.n_layers}")
    check(served["flash_attention"] == 16 * cfg.n_layers,
          f"trained paper-gpt engine: flash launches "
          f"{served['flash_attention']} != 16 x {cfg.n_layers}")
    check(bool(seen["finite"].item()), "trained paper-gpt engine: "
          "non-finite logits")
    return {k: launches[k] + served[k] for k in launches}


def phase_train_step_full_width():
    """Train steps at llama3-8b's published widths (d 4096, 32 heads over
    8 KV heads of 128, d_ff 14336, vocab 128256), 4 layers, bf16 (1.92e9
    params): B 4 x S 512 for FULL_STEPS steps on one repeated batch, each
    split into forward+backward and the AdamW update.  The loss must be
    finite and fall.  Logs the split, the FLOPs over time, the peak
    memory and its floor (params, grads and moments)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS)
    model = build_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter(
        SyntheticLM(cfg.vocab_size, FULL_S, FULL_B))).items()}
    losses, fb, upd = time_train_split(model, AdamW(lr=3e-4), params,
                                       batch, FULL_STEPS)
    peak = torch.cuda.max_memory_allocated()
    n = cfg.param_count()
    floor = n * (2 + 2 + 4 + 4)
    log(f"train step llama3-8b x{N_LAYERS} layers ({n:,} params, bf16, B "
        f"{FULL_B} x S {FULL_S}): losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {FULL_STEPS} steps on one batch; peak "
        f"memory {peak / 1e9:.2f} GB (params, grads and f32 moments "
        f"{floor / 1e9:.2f} GB)")
    log_train_split(f"llama3-8b x{N_LAYERS}", cfg, FULL_B, FULL_S, fb, upd)
    check(all(math.isfinite(x) for x in losses),
          "llama3-8b train step: a non-finite loss")
    check(losses[-1] < losses[0], f"llama3-8b train step: the loss did not "
          f"fall ({losses[0]:.4f} -> {losses[-1]:.4f})")
    del params


# ------------------------------------------- training on a DeviceMesh
# part (a): the reduced float32 widths of the CPU tests
# (``repro_torch.configs.reduced``), one train step of each family
# through ``launch.steps.train_cell`` on a (1, 1) ("data", "model") NCCL
# mesh (fsdp, sequence parallelism, remat "full"; mixtral with capacity
# dispatch; llama3-8b under the zero3 layout too) against the unsharded
# port's step on the card from the same weights and batch.  On one rank
# every explicit collective's group is None: the card holds the DTensor
# path, the placements and CUDA; the collectives' backwards are the gloo
# ranks' (``tests/test_torch_train_shard*.py``).
MESH_TRAIN = {"llama3-8b": "tp", "llama3-8b zero3": "zero3",
              "mixtral-8x7b": "tp", "rwkv6-7b": "tp", "zamba2-2.7b": "tp",
              "musicgen-large": "tp", "llama-3.2-vision-11b": "tp"}
MESH_TRAIN_OPT = dict(lr=1e-3, eps=1e-3, grad_clip=1.0)
MESH_TRAIN_REL = 1e-5        # of each leaf's largest magnitude, float32
# part (b): llama3-8b at published widths, 4 layers, bf16, one data rank's
# row of the reference's train_4k cell (B 1 x S 4096), 5 steps
MESH_FULL_B, MESH_FULL_S, MESH_FULL_STEPS = 1, 4096, 5
# the two runs' losses on the same card: the same kernels, but the mesh's
# loss is a sum over its tokens divided by their count where the plain
# one is a mean, and bf16 updates compound such a difference
MESH_FULL_LOSS_ATOL = 2e-2
# Adam's first steps move every weight by ~lr: at 3e-4 the repeated
# 4096-token batch's loss rose from 12.19 to 23.35 over 5 steps in both
# runs alike (measured on one H100), so this phase steps at 1e-5
MESH_FULL_LR = 1e-5


def perturbed_constants(params, seed=0):
    """Every constant floating leaf (zero biases, gates, adapters, ``u``,
    the SSM parameters, unit norms) moved by seeded 0.3 N(0, 1), in place:
    a zero leaf would hide a gradient summed on the wrong ranks."""
    from repro_torch.optim.adamw import tree_leaves
    rng = np.random.default_rng(seed)
    for t in tree_leaves(params):
        if t.is_floating_point() and t.numel() and bool(
                (t == t.reshape(-1)[0]).all()):
            t.add_(torch.from_numpy((0.3 * rng.standard_normal(
                tuple(t.shape))).astype(np.float32)).to(t.device, t.dtype))
    return params


def _whole_rel_err(got, want) -> float:
    """``_tree_rel_err`` with DTensor leaves read whole."""
    from repro_torch.models.partitioning import whole
    from repro_torch.optim.adamw import tree_map
    return _tree_rel_err(tree_map(whole, got), want)


def mesh_train_batch(cfg, B, S, device="cuda"):
    """One ``SyntheticLM`` batch on the card; a VLM's adds seeded image
    embeddings (8 rows, 8 and 5 valid)."""
    from repro_torch.data.pipeline import SyntheticLM
    batch = {k: torch.from_numpy(v).to(device) for k, v in next(iter(
        SyntheticLM(cfg.vocab_size, S, B))).items()}
    if cfg.family == "vlm":
        rng = np.random.default_rng(5)
        batch["img_embeds"] = torch.from_numpy((0.5 * rng.standard_normal(
            (B, 8, cfg.d_model))).astype(np.float32)).to(device)
        batch["img_mask"] = (torch.arange(8)[None] < torch.tensor(
            [8, 5][:B])[:, None]).to(device)
    return batch


def mesh_train_pair(label, layout):
    """Part (a) for one family: its step on the one-card mesh against the
    unsharded step; returns the (loss, grads, params) gaps."""
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (make_train_step, train_cell,
                                          value_and_grad)
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    t0 = time.monotonic()
    cfg = reduced_config(label.split()[0])
    model = build_model(cfg, device="cuda", remat="full",
                        capacity_moe=cfg.is_moe)
    params = perturbed_constants(model.init(
        # rpr: ignore[RPR001] -- another model's weights, from seed 0
        torch.Generator(device="cuda").manual_seed(0)))
    batch = mesh_train_batch(cfg, 2, 16)
    opt = AdamW(**MESH_TRAIN_OPT)
    loss, grads = value_and_grad(model.loss, params, batch)
    new_p, _, _ = make_train_step(model, opt)(params, opt.init(params),
                                              batch)
    step, placed, state, _ = train_cell(
        cfg, make_debug_mesh(1, 1), fsdp=True, layout=layout,
        remat="full", opt=opt, params=params)
    m_loss, m_grads = value_and_grad(step.model.loss, placed, batch)
    m_new, _, _ = step(placed, state, batch)
    gaps = (abs(m_loss.item() - loss.item()) / abs(loss.item()),
            _whole_rel_err(m_grads, grads), _whole_rel_err(m_new, new_p))
    log(f"mesh train pair {label} ({layout}, reduced f32, (1, 1) NCCL "
        f"mesh): loss {m_loss.item():.6f} vs unsharded {loss.item():.6f}; "
        f"rel gaps loss {gaps[0]:.2e}, worst grad leaf {gaps[1]:.2e}, "
        f"params after one step {gaps[2]:.2e} (limit "
        f"{MESH_TRAIN_REL:.0e}); {time.monotonic() - t0:.1f} s")
    for what, err in zip(("loss", "grads", "params"), gaps):
        check(err <= MESH_TRAIN_REL, f"mesh train {label}: {what} differ "
              f"by {err:.2e} of their scale")
    return gaps


def mesh_train_pairs():
    """Part (a): every family's pair; returns {label: gaps}."""
    gaps = {}
    for label, layout in MESH_TRAIN.items():
        gaps[label] = mesh_train_pair(label, layout)
        release()
    return gaps


def mesh_train_full_width(card):
    """Part (b): llama3-8b at published widths (d 4096, 32 q / 8 KV heads
    of 128, d_ff 14336, vocab 128256), ``N_LAYERS`` layers, bf16, B 1 x S
    4096: MESH_FULL_STEPS steps unsharded (remat "full"), the state freed,
    then the same weights through ``train_cell`` on the one-card mesh
    (fsdp, sequence parallelism, remat "full").  Logs each run's split
    (forward + backward, the update), peak memory and loss curve."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import train_cell
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS)
    B, S, n = MESH_FULL_B, MESH_FULL_S, MESH_FULL_STEPS
    model = build_model(cfg, device="cuda", remat="full")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = mesh_train_batch(cfg, B, S)
    runs = {}
    for label in ("unsharded", "mesh (1, 1)"):
        if label == "unsharded":
            run_model = model
            run_params = params
        else:
            step, run_params, _, _ = train_cell(
                cfg, make_debug_mesh(1, 1), fsdp=True, remat="full",
                opt=AdamW(lr=MESH_FULL_LR), params=params)
            run_model = step.model
        release()
        torch.cuda.reset_peak_memory_stats()
        losses, fb, upd = time_train_split(
            run_model, AdamW(lr=MESH_FULL_LR), run_params, batch, n)
        runs[label] = (losses, torch.cuda.max_memory_allocated(), fb, upd)
        del run_params
        log(f"mesh train full width {label}: llama3-8b x{N_LAYERS} bf16 B "
            f"{B} x S {S}, remat full; losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f"; peak {runs[label][1] / 1e9:.2f} GB; {card}")
        log_train_split(f"llama3-8b x{N_LAYERS} {label}", cfg, B, S, fb, upd)
    del model, params
    release()
    (lp, _, _, _), (lm, _, _, _) = runs["unsharded"], runs["mesh (1, 1)"]
    gap = max(abs(a - b) for a, b in zip(lp, lm))
    log(f"mesh train full width: losses within {gap:.2e} of the "
        f"unsharded run's (limit {MESH_FULL_LOSS_ATOL:.0e})")
    check(all(math.isfinite(x) for x in lp + lm),
          "mesh train full width: a non-finite loss")
    check(gap <= MESH_FULL_LOSS_ATOL, f"mesh train full width: losses "
          f"differ by {gap:.2e}")
    check(lm[-1] < lm[0], f"mesh train full width: the loss did not fall "
          f"({lm[0]:.4f} -> {lm[-1]:.4f})")
    return runs


def phase_mesh_train(card):
    """Training on a one-card ("data", "model") NCCL mesh: part (a)'s
    reduced f32 pairs of every family, part (b) at full width.  Training
    runs the plain path: no kernel launches (checked)."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked

    def counts():
        # the counters as the records read them: earlier phases' counts
        # stay, so the phase compares before with after
        return {**read_launches(), "rwkv6_chunked": rwkv6_chunked.launches}
    t0 = time.monotonic()
    torch.cuda.synchronize()
    before = counts()
    with one_rank_nccl():
        mesh_train_pairs()
        mesh_train_full_width(card)
    launched = {k: n - before[k] for k, n in counts().items()
                if n != before[k]}
    check(not launched, f"mesh training launched kernels: {launched}")
    log(f"mesh train phase: no kernel launched; "
        f"{time.monotonic() - t0:.1f} s")


# ------------------------------------ the tensor-parallel layout (tp 16)
def migration_rows(eng) -> list:
    """Per applied interval with migrations: the KV-row copies its
    ``mig_bytes`` pays for (bytes over one k+v row of the live extent)."""
    hd = eng.model.hd
    per_row = eng.n_slots * eng.max_seq * 2 * hd.dh * \
        torch.finfo(torch.bfloat16 if eng.cfg.dtype == "bfloat16"
                    else torch.float32).bits // 8
    out = []
    for e in eng.migration_log:
        if e["applied"] and e["n_migrations"]:
            check(e["mig_bytes"] % (hd.rep * per_row) == 0,
                  f"mig_bytes {e['mig_bytes']} is no multiple of rep "
                  f"{hd.rep} x {per_row} bytes a row")
            out.append(e["mig_bytes"] // per_row)
    return out


def check_replicas(cache, hd, label):
    """Expanded row o·rep + r of every cache layer is replica r of KV head
    o: after any applied migration the replicas still sit together, bit
    for bit."""
    for name in ("k", "v"):
        t = cache[name]
        t = t.view(t.shape[:-2] + (hd.Kp, hd.rep, hd.dh))
        check(torch.equal(t, t[..., :1, :].expand_as(t)),
              f"{label}: the {name} cache's KV replicas differ")


def tp_serve_run(label, cfg, eng, on_interval=None):
    """Drive ``eng`` (every request submitted) to its end with a 500x
    straggler at step 16, its kernel launches counted; checks every
    request finished with 64 tokens, exact resident and flash launches
    and an applied migration.  ``on_interval(eng)`` runs after every
    interval that applied one.  Returns (launches, wall, metrics)."""
    seen = watch_logits(eng)
    prefill = time_prefill(eng)
    reset_launches()
    t0 = time.monotonic()
    n_log = 0
    while drive(eng):
        if on_interval is not None and len(eng.migration_log) > n_log:
            n_log = len(eng.migration_log)
            last = eng.migration_log[-1]
            if last["applied"] and last["n_migrations"]:
                on_interval(eng)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    m = path_metrics(eng, wall)
    hd = eng.model.hd
    applied = [e for e in eng.migration_log
               if e["applied"] and e["n_migrations"]]
    log(f"{label}: Hp {hd.Hp}, Kp {hd.Kp}, rep {hd.rep}, KvE {hd.KvE}, G "
        f"{hd.Hp // hd.KvE}; {len(eng.finished)} requests, "
        f"{sum(len(r.out_tokens) for r in eng.finished)} tokens, "
        f"{eng.decode_steps} decode steps in {wall:.2f} s ({m['tok/s']:.1f} "
        f"tok/s); decode step median {m['step median ms']:.2f} ms; "
        f"{len(eng.interval_times)} controller intervals, mean "
        f"{m['interval mean ms']:.1f} ms; "
        f"{sum(e['n_migrations'] for e in eng.migration_log)} head "
        f"migrations in {len(applied)} applied intervals, KV rows moved "
        f"per applied interval {migration_rows(eng)}; launches "
        f"resident {launches['decode_attention_resident']}, flash "
        f"{launches['flash_attention']}")
    log_split(eng, wall, prefill)
    check(len(eng.finished) == 16 and all(len(r.out_tokens) == 64
                                          for r in eng.finished),
          f"{label}: not every request finished with its 64 tokens")
    check(bool(applied), f"{label}: no interval applied a migration")
    check(launches["decode_attention_resident"]
          == eng.decode_steps * cfg.n_layers,
          f"{label}: resident launches "
          f"{launches['decode_attention_resident']} != decode steps "
          f"{eng.decode_steps} x {cfg.n_layers}")
    check(launches["flash_attention"] == 16 * cfg.n_layers,
          f"{label}: flash launches {launches['flash_attention']} != 16 x "
          f"{cfg.n_layers}")
    check(not any(n for k, n in launches.items()
                  if k not in ("decode_attention_resident",
                               "flash_attention")),
          f"{label}: another kernel launched: {launches}")
    check(bool(seen["finite"].item()), f"{label}: non-finite logits")
    return launches, wall, m


def phase_tp_dense():
    """The dense path's config, traffic and engine — llama3-8b at published
    widths, 4 layers, bf16, 8 slots, 16 requests of 32-512 tokens, 64 new
    each, λ 8, 4 simulated devices, a straggler at step 16 — built in the
    tp-16 layout: each of the 8 KV heads replicated twice into a (4, 8,
    1024, 16, 128) cache, the resident kernel at G 2, flash at 32 heads
    over 16.  Migrations move each supergroup of 4 query heads with its KV
    head's 2 rows (``mig_bytes`` counts both).  The tp-1 engine serves the
    same weights and traffic first, so both run warm, side by side.
    Returns the launches of both."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS)
    eng1 = serve(cfg, use_kernel=True, n_requests=16, max_new=64)
    launches1, _, m1 = tp_serve_run(f"tp 1 dense bf16 llama3-8b x{N_LAYERS} "
                                    f"layers", cfg, eng1)
    params = eng1.params
    del eng1
    release()
    eng = serve(cfg, use_kernel=True, n_requests=16, max_new=64, tp=TP,
                params=params)
    hd = eng.model.hd
    k = eng.state["cache"]["k"]
    check((hd.rep, hd.Kp, hd.KvE) == (2, 8, 16),
          f"tp dense: head layout {hd}")
    check(tuple(k.shape) == (N_LAYERS, MAIN_B, MAIN_T, 16, 128)
          and k.dtype == torch.bfloat16, f"tp dense: cache {tuple(k.shape)}")
    log(f"tp dense cache: k and v {tuple(k.shape)} bf16, "
        f"{2 * k.numel() * k.element_size() / 1e9:.3f} GB")
    launches, _, m = tp_serve_run(f"tp {TP} dense bf16 llama3-8b "
                                  f"x{N_LAYERS} layers", cfg, eng)
    check_replicas(eng.state["cache"], hd, "tp dense")
    log("  tp 16 beside tp 1, same weights and traffic: " + "; ".join(
        f"{name} {m[name]:.2f} vs {m1[name]:.2f}" for name in m))
    return {k: launches[k] + launches1[k] for k in launches}


def seed_real_qkv_bias(params, n_real: int, seed=0):
    """``bq``/``bk``/``bv`` set in place to 0.5 N(0, 1) on the first
    ``n_real`` heads (the real ones), the padded rows left at zero."""
    attn = params["layers"]["attn"]
    dev = attn["bq"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name in ("bq", "bk", "bv"):
        t = attn[name][..., :n_real, :]
        t.copy_(0.5 * torch.randn(t.shape, generator=gen, device=dev))


def track_layout(eng):
    """The heads' physical layout, kept up to date: (L, Hp), position p of
    layer l holding head ``layout[l][p]`` of the init's order.  The
    weights start in that order and each applied migration takes their
    head axis by the plan's relative permutation (``_migrate_state``), so
    the layout composes those permutations."""
    from repro_torch.core.placement_bridge import relative_perms
    hd = eng.model.hd
    layout = np.tile(np.arange(hd.Hp), (eng.cfg.n_layers, 1))
    inner = eng._migrate_state

    def migrate(state, plan, *a, **kw):
        applied, reason = inner(state, plan, *a, **kw)
        if applied:
            rel = relative_perms(plan["prev_perms"], plan["perms"])
            rel = np.broadcast_to(rel, layout.shape)
            layout[:] = np.take_along_axis(layout, rel, axis=1)
        return applied, reason

    eng._migrate_state = migrate
    return layout


def padded_rows(params, layout, n_real):
    """(largest magnitude on the padded heads' rows, smallest row norm of a
    real head's ``wq``) over every layer, the heads found through the
    physical layout (``track_layout``)."""
    attn = params["layers"]["attn"]
    dev = attn["wq"].device
    worst, least = 0.0, math.inf
    for l, row in enumerate(np.asarray(layout)):
        pad = torch.as_tensor(np.flatnonzero(row >= n_real), device=dev)
        real = torch.as_tensor(np.flatnonzero(row < n_real), device=dev)
        for name, axis in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0),
                           ("bq", 0), ("bk", 0), ("bv", 0)):
            t = attn[name][l]
            worst = max(worst, t.index_select(axis, pad).abs().max().item())
        least = min(least, attn["wq"][l].index_select(1, real).float()
                    .norm(dim=(0, 2)).min().item())
    return worst, least


def phase_tp_padded():
    """qwen1.5-32b at published widths (d 5120, 40 heads of 128 zero-padded
    to 48 at tp 16, one KV head each, QKV bias, d_ff 27392, vocab 152064),
    4 layers, bf16: the resident kernel at 48 heads over 48 (G 1), flash at
    48 over 48, on the dense path's traffic.  The biases are seeded on the
    40 real heads; the padded heads' rows of wq, wk, wv, wo and the biases
    must be exactly zero at the start and after every applied migration
    (found through the layout the engine applied).  Returns the
    launches."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen1.5-32b").with_overrides(n_layers=N_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = serve(cfg, use_kernel=True, n_requests=16, max_new=64, tp=TP)
    hd = eng.model.hd
    check((hd.H, hd.Hp, hd.Kp, hd.rep, hd.KvE) == (40, 48, 48, 1, 48),
          f"tp padded: head layout {hd}")
    seed_real_qkv_bias(eng.params, QWEN_REAL_HEADS)
    weights = sum(t.numel() * t.element_size() for t in _leaves(eng.params))
    k = eng.state["cache"]["k"]
    ident = np.broadcast_to(np.arange(hd.Hp), (cfg.n_layers, hd.Hp))
    worst, least = padded_rows(eng.params, ident, QWEN_REAL_HEADS)
    log(f"tp padded qwen1.5-32b: {weights / 1e9:.2f} GB of weights; cache k "
        f"and v {tuple(k.shape)} bf16, {2 * k.numel() * k.element_size() / 1e9:.3f} "
        f"GB; padded rows at init: largest |value| {worst}, smallest real "
        f"wq head norm {least:.3f}")
    check(worst == 0.0 and least > 0, "tp padded: padded rows not zero at "
          "init")
    checked = []
    layout = track_layout(eng)

    def after_migration(e):
        w, lst = padded_rows(e.params, layout, QWEN_REAL_HEADS)
        checked.append((w, lst))
        check(w == 0.0 and lst > 0, f"tp padded: a padded head's row is "
              f"{w} after a migration (smallest real norm {lst})")

    launches, _, _ = tp_serve_run(f"tp {TP} padded bf16 qwen1.5-32b "
                                  f"x{N_LAYERS} layers", cfg, eng,
                                  after_migration)
    moved = int((layout != np.arange(hd.Hp)).sum())
    log(f"  padded rows exactly zero after each of {len(checked)} applied "
        f"migrations ({moved} (layer, position) cells off the identity at "
        f"the end); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(bool(checked), "tp padded: no migration was checked")
    return launches


def phase_tp_stream_pair():
    """float32, 2 layers of llama3-8b at published widths: engines at tp 16
    (rep 2) and tp 1 on the same weights, and tp 16 without the kernels,
    driven in step over 8 requests of 32-512 tokens, once with a 500x
    straggler at step 8 (migrations applied: the tp-16 logs equal the tp-1
    ones with rep x the bytes) and once without.  Greedy streams must be
    equal, every step's logits within STREAM_LOGIT_ATOL."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, dtype="float32", param_dtype="float32")
    params = build_model(cfg, tp=TP, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    keys = ("step", "n_migrations", "applied")
    for straggle_at in (8, None):
        engines = {name: serve(cfg, use_kernel=uk, n_requests=8,
                               max_new=32, params=params, tp=tp)
                   for name, tp, uk in (("tp16 kernels", TP, True),
                                        ("tp1 kernels", 1, True),
                                        ("tp16 plain", TP, False))}
        seen = {n: watch_logits(e) for n, e in engines.items()}
        worst = {n: 0.0 for n in engines}
        while True:
            more = [drive(e, straggle_at=straggle_at if straggle_at
                          is not None else -1) for e in engines.values()]
            check(len(set(more)) == 1, "tp pair: engines stopped apart")
            if not more[0]:
                break
            ref = engines["tp16 kernels"]
            active = ref._active()
            if active:
                for n in engines:
                    worst[n] = max(worst[n], (seen[n]["last"][active]
                                              - seen["tp16 kernels"]["last"]
                                              [active]).abs().max().item())
        streams = {n: {r.rid: r.out_tokens for r in e.finished}
                   for n, e in engines.items()}
        logs = {n: [tuple(m[k] for k in keys) for m in e.migration_log]
                for n, e in engines.items()}
        moved = {n: sum(m[1] for m in lg if m[2]) for n, lg in logs.items()}
        rows = {n: migration_rows(e) for n, e in engines.items()}
        label = "with a straggler" if straggle_at else "without a straggler"
        log(f"f32 tp streams {label} (llama3-8b x2 layers): "
            f"{len(streams['tp16 kernels'])} requests; largest per-step "
            f"logit gap to tp 16 with kernels: tp 1 {worst['tp1 kernels']:.3e}, "
            f"tp 16 plain {worst['tp16 plain']:.3e}; applied migrations "
            f"{moved}; KV rows moved per interval {rows}")
        check(len(streams["tp16 kernels"]) == 8
              and all(s == streams["tp16 kernels"]
                      for s in streams.values()),
              f"tp streams {label}: greedy streams differ")
        check(max(worst.values()) <= STREAM_LOGIT_ATOL,
              f"tp streams {label}: logits differ by {worst}")
        check(all(lg == logs["tp16 kernels"] for lg in logs.values()),
              f"tp streams {label}: migration logs differ")
        check(rows["tp16 kernels"] == [2 * r for r in rows["tp1 kernels"]],
              f"tp streams {label}: tp-16 rows moved {rows['tp16 kernels']} "
              f"are not twice tp 1's {rows['tp1 kernels']}")
        if straggle_at:
            check(min(moved.values()) > 0,
                  f"tp streams {label}: no migration was applied")
        else:
            check(not any(moved.values()),
                  f"tp streams {label}: a migration was applied")
        check(all(bool(s["finite"].item()) for s in seen.values()),
              f"tp streams {label}: non-finite logits")
        del engines, seen
        release()
    del params


def phase_mesh_one_card():
    """A (1, 1) ("data", "model") DeviceMesh over NCCL on the one card, as
    ``ElasticMesh`` builds it: llama3-8b's 4-layer params at published
    widths (bf16) placed by ``param_shardings``, saved, and restored
    through ``elastic_restore`` — every leaf's sha1 equal; then the
    sharded ``forward`` through the flash kernel (``make_partitioner``)
    against the unsharded model's, with and without the kernels.  Runs
    across several cards wait for a four-card machine."""
    import hashlib
    import socket
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import Checkpointer, to_host
    from repro_torch.configs import get_config
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner, place
    from repro_torch.runtime.elastic import ElasticMesh, elastic_restore
    from repro_torch.tree import flatten, unflatten
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    tmp = tempfile.mkdtemp(prefix="mesh_ckpt_")
    try:
        em = ElasticMesh(prefer_model=16)
        mesh = em.mesh
        check(tuple(mesh.mesh.shape) == (1, 1)
              and tuple(mesh.mesh_dim_names) == ("data", "model"),
              f"mesh {mesh}")
        params = build_model(cfg, device="cuda").init(
            torch.Generator(device="cuda").manual_seed(0))

        def shardings(m):
            return {"params": param_shardings(params, cfg, m)}

        sh = flatten(shardings(mesh)["params"])
        placed = unflatten(params, {p: place(v, sh[p]) for p, v in
                                    flatten(params).items()})

        def leaves(tree):
            """{checkpoint key: leaf} of a params tree."""
            return {"/".join(("params",) + p): v
                    for p, v in flatten(tree).items()}

        want_sha = {k: hashlib.sha1(to_host(v)[0].tobytes()).hexdigest()
                    for k, v in leaves(params).items()}
        ck = Checkpointer(tmp)
        t0 = time.monotonic()
        ck.save(1, {"params": placed})
        t_save = time.monotonic() - t0
        em2 = em.resize([0])
        t0 = time.monotonic()
        restored = elastic_restore(ck, 1, {"params": params}, shardings,
                                   em2.mesh)["params"]
        torch.cuda.synchronize()
        t_restore = time.monotonic() - t0
        # the saved bytes' sha1 against the original leaves' (restore
        # verified the bytes it read against the same sha1s), and every
        # restored leaf bit-equal to its original on the card
        manifest = json.loads((Path(tmp) / "step_00000001" /
                               "manifest.json").read_text())["leaves"]
        differ = [k for k in want_sha if manifest[k]["sha1"] != want_sha[k]]
        orig = leaves(params)
        differ += [k for k, v in leaves(restored).items()
                   if not torch.equal(v.full_tensor(), orig[k])]
        log(f"mesh (1, 1) over NCCL: {len(want_sha)} leaves placed, saved in "
            f"{t_save:.2f} s, restored through elastic_restore in "
            f"{t_restore:.2f} s ({ck.log[-1]['bytes'] / 1e9:.2f} GB); leaves "
            f"whose sha1 or restored bits differ: {len(differ)}")
        check(not differ, f"mesh restore: leaves differ {differ[:4]}")
        del placed
        release()
        tokens = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (2, 512))).cuda()
        with torch.no_grad():
            flash_attention.launches = 0
            sharded = build_model(cfg, part=make_partitioner(em2.mesh),
                                  use_kernel=True, device="cuda").forward(
                restored, tokens)[0]
            launched = flash_attention.launches
            check(type(sharded).__name__ == "DTensor",
                  "the sharded forward returned no DTensor")
            sharded = sharded.full_tensor()
            kern = build_model(cfg, use_kernel=True, device="cuda").forward(
                params, tokens)[0]
            plain = build_model(cfg, device="cuda").forward(params,
                                                            tokens)[0]
        gap_kern = (sharded - kern).abs().max().item()
        rel_plain = row_rel_err(sharded, plain)
        log(f"  sharded forward (2 x 512 tokens, bf16, flash {launched} "
            f"launches): largest logit gap to the unsharded kernel forward "
            f"{gap_kern:.3e} (limit {TOLS[torch.bfloat16]['atol']}); per-row "
            f"relative gap to the plain forward {rel_plain:.3e} (limit "
            f"{CAPACITY_ROW_REL}: the same function, bf16 rounded at other "
            f"points, down {cfg.n_layers} layers)")
        check(launched == cfg.n_layers, f"sharded forward: flash launches "
              f"{launched} != {cfg.n_layers}")
        check(torch.allclose(sharded, kern, **TOLS[torch.bfloat16]),
              "sharded forward differs from the unsharded one")
        check(rel_plain <= CAPACITY_ROW_REL,
              "sharded forward differs from the plain one")
        del restored, sharded, kern, plain, params
        return launched
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()


# ------------------- sharded decode and serving on a DeviceMesh (tp 4, 1)
SHARDS = 4            # the tp-4 layout's head shards, one a rank
MESH_REQUESTS, MESH_NEW, MESH_STRAGGLE = 8, 32, 8


def straggler_rows(cfg):
    """A straggler plan's kernel row maps: a narrow engine with ``cfg``'s
    heads (32 over 8 KV heads, head width 16, d 256), its controller
    pricing ``cfg``'s widths (``cost_cfg``), serves the dense path's
    prompts with a 500x straggler at step 16; returns the last plan's rows
    (L, H) through the layout its migrations applied (``track_layout``)
    and the number of applied migrations."""
    from repro_torch.core.placement_bridge import head_row_maps
    small = cfg.with_overrides(n_layers=N_LAYERS, d_model=256, d_head=16,
                               d_ff=512, vocab_size=1024)
    eng = serve(small, use_kernel=True, n_requests=MESH_REQUESTS,
                max_new=MESH_NEW, cost_cfg=cfg)
    layout = track_layout(eng)
    while drive(eng, straggle_at=MESH_STRAGGLE):
        pass
    rows, _ = head_row_maps(eng.controller.place, eng.controller.blocks,
                            eng.net.n_devices, eng.model.hd.Hp,
                            perms=layout)
    applied = sum(1 for e in eng.migration_log
                  if e["applied"] and e["n_migrations"])
    return np.broadcast_to(rows, layout.shape).copy(), layout, applied


def shard_args(args, r, n, nk):
    """Rank ``r``'s share of a decode kernel's arguments in the tp-4
    layout: its ``n`` q heads and ``nk`` KV rows (dimension 1 of q and of
    every K/V, scale and page-store view); lengths and page maps
    whole."""
    q = args[0][:, r * n:(r + 1) * n]
    return (q,) + tuple(a[:, r * nk:(r + 1) * nk] if a.dim() >= 3 else a
                        for a in args[1:])


def phase_shard_kernels_vs_plain():
    """Each of the four decode kernels on each of the tp-4 layout's head
    shards of llama3-8b at published widths (the tp-4 layout is tp 1's:
    32 q heads over 8 KV heads, dh 128; a shard 8 over 2; B 8, T 1024,
    paged at P 64 over a scrambled pool; lengths 0, 1, T-1, T, T+1 and
    between), every layer's rows of a straggler plan localized to each
    shard (``partitioning.local_head_rows``, through the layout its
    migrations applied): each shard's output held to its plain version,
    and the four shards put together to the whole call, each at the
    kernel phase's tolerance (TOLS and DECODE_ROW_REL; the split is
    picked from KvE, so a shard merges in another order than the whole
    call: not bit-equal).  Then one shard's four calls timed against the
    whole call (bf16).  Comparison launches: not counted."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.layers import head_dims
    from repro_torch.models.partitioning import local_head_rows
    cfg = get_config("llama3-8b")
    hd = head_dims(cfg, SHARDS)
    check((hd.Hp, hd.KvE, hd.dh) == (MAIN_H, MAIN_KVE, MAIN_DH),
          f"tp-4 llama3-8b layout {hd}")
    rows, layout, applied = straggler_rows(cfg)
    moved = int((layout != np.arange(hd.Hp)).sum())
    log(f"shard kernels: a straggler plan of llama3-8b x{N_LAYERS} layers "
        f"after {applied} applied migrations, {moved} (layer, position) "
        f"cells off the identity layout")
    check(applied > 0 and moved > 0, "shard kernels: no migration applied")
    n, nk = hd.Hp // SHARDS, hd.KvE // SHARDS
    local = [local_head_rows(rows, r * n, n) for r in range(SHARDS)]
    for r, (lr, _) in enumerate(local):
        check(all(set(row // hd.groups) == set(range(nk)) for row in lr),
              f"shard {r}: its rows split a KV group")
    lengths = [0, 1, MAIN_T - 1, MAIN_T, MAIN_T + 1, 37, 512, 700]
    failed = []
    for kind, (name, _, _) in PATHS.items():
        kern, plain = getattr(da, name), getattr(da, name + "_plain")
        worst = {"plain": 0.0, "whole": 0.0}
        for dt in (torch.float32, torch.bfloat16):
            args = kv_inputs(kind, dt, lengths=lengths, seed=11)[:-1]
            for l in range(N_LAYERS):
                whole = kern(*args, torch.as_tensor(rows[l], device="cuda"))
                whole = whole[:, torch.as_tensor(np.argsort(rows[l]),
                                                 device="cuda")]
                parts = []
                for r, (lr, li) in enumerate(local):
                    sargs = shard_args(args, r, n, nk)
                    lrows = torch.as_tensor(lr[l], device="cuda")
                    out = kern(*sargs, lrows)
                    want = plain(*sargs, lrows)
                    rel = row_rel_err(out, want)
                    worst["plain"] = max(worst["plain"], rel)
                    if not (torch.allclose(out.float(), want.float(),
                                           **TOLS[dt])
                            and rel <= DECODE_ROW_REL[dt]):
                        failed.append(f"{name} {dt} layer {l} shard {r} "
                                      f"vs plain ({rel:.3e})")
                    parts.append(out[:, torch.as_tensor(li[l],
                                                        device="cuda")])
                together = torch.cat(parts, dim=1)
                rel = row_rel_err(together, whole)
                worst["whole"] = max(worst["whole"], rel)
                if not (torch.allclose(together.float(), whole.float(),
                                       **TOLS[dt])
                        and rel <= DECODE_ROW_REL[dt]):
                    failed.append(f"{name} {dt} layer {l}: shards put "
                                  f"together vs the whole call ({rel:.3e})")
        args = kv_inputs(kind, torch.bfloat16, lengths=lengths, seed=11)[:-1]
        whole_rows = torch.as_tensor(rows[-1], device="cuda")
        shard_calls = [(shard_args(args, r, n, nk),
                        torch.as_tensor(lr[-1], device="cuda"))
                       for r, (lr, _) in enumerate(local)]
        ms_whole = cuda_ms([lambda: kern(*args, whole_rows)])
        ms_shard = cuda_ms([lambda s=s: kern(*s[0], s[1])
                            for s in shard_calls])
        log(f"{name} on the tp-4 shards ({SHARDS} x {n} q heads over {nk} "
            f"KV rows, every layer's localized straggler rows): worst "
            f"per-row relative gap to the plain version {worst['plain']:.3e},"
            f" of the shards put together to the whole call "
            f"{worst['whole']:.3e} (limit "
            f"{DECODE_ROW_REL[torch.bfloat16]:.0e} bf16, "
            f"{DECODE_ROW_REL[torch.float32]:.0e} f32); bf16 {ms_shard:.4f} "
            f"ms a shard against {ms_whole:.4f} ms the whole call")
    check(not failed, "shard kernels: " + "; ".join(failed[:6]))
    shard_ring_vs_plain()
    release()
    zamba2_shared_block_shards()


def shard_ring_vs_plain():
    """The ring kernel on each tp-4 head shard of mixtral-8x7b at
    published widths (the tp-4 layout is tp 1's: 32 q heads over 8 KV
    heads, dh 128; a shard 8 over 2), B 4 over a wrapped 4096-slot ring
    (lengths 8192, 8000, 6001, 4097), every layer's rows of a mixtral
    straggler plan localized to each shard through the layout its
    migrations applied; the slot positions are the whole ring's on every
    shard (replicated, as the decode-state rule places them).  Each
    shard's output held to its plain version, and the four put together
    to the whole call, at TOLS and RING_ROW_REL (f32 and bf16); then one
    shard's call timed against the whole call (bf16).  Comparison
    launches: not counted.  Returns (ms a shard, ms the whole call)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention_ring_resident as kern,
        decode_attention_ring_resident_plain as plain)
    from repro_torch.models.layers import head_dims
    from repro_torch.models.partitioning import local_head_rows
    cfg = get_config("mixtral-8x7b")
    hd = head_dims(cfg, SHARDS)
    check((hd.Hp, hd.KvE, hd.dh) == (MAIN_H, MAIN_KVE, MAIN_DH),
          f"tp-4 mixtral-8x7b layout {hd}")
    rows, layout, applied = straggler_rows(cfg)
    moved = int((layout != np.arange(hd.Hp)).sum())
    log(f"shard ring kernel: a straggler plan of mixtral-8x7b x{N_LAYERS} "
        f"layers after {applied} applied migrations, {moved} (layer, "
        f"position) cells off the identity layout")
    check(applied > 0 and moved > 0, "shard ring: no migration applied")
    n, nk = hd.Hp // SHARDS, hd.KvE // SHARDS
    local = [local_head_rows(rows, r * n, n) for r in range(SHARDS)]
    lengths = [8192, 8000, 6001, 4097]
    worst = {"plain": 0.0, "whole": 0.0}
    failed = []
    for i, dt in enumerate((torch.float32, torch.bfloat16)):
        args = ring_inputs(dt, n_written=8192, lengths=lengths,
                           seed=20 + i)[:-1]
        for l in range(N_LAYERS):
            whole = kern(*args, torch.as_tensor(rows[l], device="cuda"),
                         window=RING_W)
            whole = whole[:, torch.as_tensor(np.argsort(rows[l]),
                                             device="cuda")]
            parts = []
            for r, (lr, li) in enumerate(local):
                sargs = shard_args(args, r, n, nk)
                lrows = torch.as_tensor(lr[l], device="cuda")
                out = kern(*sargs, lrows, window=RING_W)
                want = plain(*sargs, lrows, window=RING_W)
                rel = row_rel_err(out, want)
                worst["plain"] = max(worst["plain"], rel)
                if not (torch.allclose(out.float(), want.float(), **TOLS[dt])
                        and rel <= RING_ROW_REL[dt]):
                    failed.append(f"{dt} layer {l} shard {r} vs plain "
                                  f"({rel:.3e})")
                parts.append(out[:, torch.as_tensor(li[l], device="cuda")])
            together = torch.cat(parts, dim=1)
            rel = row_rel_err(together, whole)
            worst["whole"] = max(worst["whole"], rel)
            if not (torch.allclose(together.float(), whole.float(),
                                   **TOLS[dt])
                    and rel <= RING_ROW_REL[dt]):
                failed.append(f"{dt} layer {l}: shards put together vs the "
                              f"whole call ({rel:.3e})")
    args = ring_inputs(torch.bfloat16, n_written=8192, lengths=lengths,
                       seed=21)[:-1]
    whole_rows = torch.as_tensor(rows[-1], device="cuda")
    shard_calls = [(shard_args(args, r, n, nk),
                    torch.as_tensor(lr[-1], device="cuda"))
                   for r, (lr, _) in enumerate(local)]
    ms_whole = cuda_ms([lambda: kern(*args, whole_rows, window=RING_W)])
    ms_shard = cuda_ms([lambda s=s: kern(*s[0], s[1], window=RING_W)
                        for s in shard_calls])
    q, _, _, lens, slot_pos = shard_calls[0][0]
    bound, bound_by = decode_bound_ms(
        q, lens, shard_calls[0][1], nk, RING_W,
        valid=int(ring_valid(lens, slot_pos).sum()), extra_bytes=4 * RING_W)
    log(f"decode_attention_ring_resident on the tp-4 shards ({SHARDS} x {n} "
        f"q heads over {nk} KV rows, window {RING_W}, every layer's "
        f"localized straggler rows): worst per-row relative gap to the "
        f"plain version {worst['plain']:.3e}, of the shards put together to "
        f"the whole call {worst['whole']:.3e} (limit "
        f"{RING_ROW_REL[torch.bfloat16]:.0e} bf16, "
        f"{RING_ROW_REL[torch.float32]:.0e} f32); bf16 {ms_shard:.4f} ms a "
        f"shard (bound {bound:.4f} ms, {bound_by}) against {ms_whole:.4f} "
        f"ms the whole call")
    check(not failed, "shard ring kernel: " + "; ".join(failed[:6]))
    return ms_shard, ms_whole


def phase_mesh_serving():
    """``ServingEngine(part=..., use_kernel=True)`` on a (1, 1) ("data",
    "model") NCCL mesh: llama3-8b at published widths, 4 layers, bf16,
    8 slots and a 1024-token cache, 8 requests of 32-512 tokens, 32 new
    each, λ 8, a 500x straggler at step 8; its params placed by
    ``param_shardings`` and its cache by ``decode_state_shardings``, from
    each path's cache (dense, paged: 48 pages of 64, int8, int8-paged).
    Each path runs first unsharded on the same weights and traffic; the
    sharded engine's kernel counts are set to 0 just before it is driven
    and read just after.  Checks: greedy streams and migration logs equal
    to the unsharded engine's, an applied migration, the local cache
    shard (L, B, T, KvE, dh) (or the page store) written in place (one
    ``data_ptr`` per buffer over every decode step), decode launches ==
    decode steps x layers, flash == requests x layers on the linear
    caches (0 paged), no other kernel.  NCCL refuses two ranks on one
    card, so the rows a migration sends between ranks are 0 here (the
    4-rank CPU test counts them).  Returns the launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.partitioning import local, make_partitioner
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS)
    added = {"flash_attention": 0}
    with one_rank_nccl():
        part = make_partitioner(make_debug_mesh(1, 1))
        params = None
        for path, (name, over, kw) in PATHS.items():
            c = cfg.with_overrides(**over)
            engines = {}
            for label, extra in (("unsharded", {}), ("mesh", dict(part=part))):
                torch.cuda.reset_peak_memory_stats()
                eng = serve(c, use_kernel=True, n_requests=MESH_REQUESTS,
                            max_new=MESH_NEW, params=params, **kw, **extra)
                params = params or eng.params
                bufs = list(eng.state["cache"].values())
                ptrs = {local(t).data_ptr() for t in bufs}
                seen = watch_logits(eng)
                prefill = time_prefill(eng)
                reset_launches()
                t0 = time.monotonic()
                while drive(eng, straggle_at=MESH_STRAGGLE):
                    ptrs |= {local(t).data_ptr() for t in
                             eng.state["cache"].values()}
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                launches = read_launches()
                engines[label] = (eng, launches, wall, prefill, seen)
            eng1 = engines["unsharded"][0]
            eng, launches, wall, prefill, seen = engines["mesh"]
            m = path_metrics(eng, wall)
            m1 = path_metrics(eng1, engines["unsharded"][2])
            shard = tuple(local(eng.state["cache"]["k"]).shape)
            applied = [e for e in eng.migration_log
                       if e["applied"] and e["n_migrations"]]
            sent = [(e["kv_rows"], e["kv_bytes"]) for e in eng.exchange_log]
            log(f"mesh (1, 1) {path} llama3-8b x{N_LAYERS} bf16: "
                f"{len(eng.finished)} requests, "
                f"{sum(len(r.out_tokens) for r in eng.finished)} tokens, "
                f"{eng.decode_steps} decode steps in {wall:.2f} s "
                f"({m['tok/s']:.1f} tok/s; unsharded {m1['tok/s']:.1f}); "
                f"decode step median {m['step median ms']:.2f} ms "
                f"(unsharded {m1['step median ms']:.2f}); controller "
                f"intervals mean {m['interval mean ms']:.1f} ms; local cache "
                f"shard {shard}; {len(applied)} applied migrations, KV rows "
                f"moved {[e['mig_bytes'] for e in applied]} bytes "
                f"(migration_log), sent to other ranks {sent}; launches "
                f"{ {k: v for k, v in launches.items() if v} }; peak memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            log_split(eng, wall, prefill)
            streams = [{r.rid: r.out_tokens for r in e.finished}
                       for e in (eng, eng1)]
            keys = ("step", "n_migrations", "mig_bytes", "applied")
            logs = [[tuple(x[k] for k in keys) for x in e.migration_log]
                    for e in (eng, eng1)]
            check(len(streams[0]) == MESH_REQUESTS
                  and streams[0] == streams[1],
                  f"mesh {path}: streams differ from the unsharded engine's")
            check(logs[0] == logs[1], f"mesh {path}: migration logs differ")
            check(bool(applied), f"mesh {path}: no migration was applied")
            check(len(ptrs) == len(bufs), f"mesh {path}: a cache buffer "
                  f"moved in memory ({len(ptrs)} pointers for {len(bufs)})")
            flash = 0 if "paged" in path else MESH_REQUESTS * N_LAYERS
            check(launches[name] == eng.decode_steps * N_LAYERS
                  and launches["flash_attention"] == flash
                  and not any(v for k, v in launches.items()
                              if k not in (name, "flash_attention")),
                  f"mesh {path}: launches {launches} (decode steps "
                  f"{eng.decode_steps})")
            check(bool(seen["finite"].item()), f"mesh {path}: non-finite "
                  f"logits")
            added[name] = launches[name]
            added["flash_attention"] += launches["flash_attention"]
            del engines, eng, eng1, seen
            release()
        del params
        return added


@contextlib.contextmanager
def one_rank_nccl():
    """A one-rank NCCL process group on card 0 (NCCL refuses two ranks on
    one card), destroyed when the phase ends, whatever its outcome."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def phase_mesh_moe_serving():
    """``WaveServingEngine(part=..., use_kernel=True)`` on a (1, 1, 1)
    ("pod", "data", "model") NCCL mesh: mixtral-8x7b at published widths,
    ``N_LAYERS`` layers, bf16, through ``make_engine(mode="auto")`` over
    the 4096-slot ring (4 slots; 8 requests of 4096-token prompts in 2
    waves, ``MESH_NEW`` new tokens each, λ 8, the expert straggler at step
    ``MESH_STRAGGLE``), its expert stacks placed over "pod", its ring by
    the decode-state rules.  The same weights and traffic run first
    through the unsharded engine.  The sharded engine's kernel counts are
    set to 0 just before it is driven and read just after.  Checks: greedy
    streams and migration logs equal to the unsharded engine's, an expert
    and a head migration applied, ring launches == decode steps x layers,
    flash == waves x layers, no other kernel, each wave's local ring
    shards written in place (one ``data_ptr`` per buffer over its decode
    steps), the local expert stacks (L, E, D, F).  Returns the launches by
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import (is_dtensor, local,
                                                 make_partitioner)
    cfg = get_config("mixtral-8x7b").with_overrides(n_layers=N_LAYERS)
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    runs = {}
    with one_rank_nccl():
        part = make_partitioner(make_mesh((1, 1, 1),
                                          ("pod", "data", "model")))
        for label, extra in (("unsharded", {}), ("mesh", dict(part=part))):
            torch.cuda.reset_peak_memory_stats()
            # the engines copy what they permute: ``params`` stays as drawn
            eng = mixtral_engine(cfg, use_kernel=True, n_requests=8,
                                 max_new=MESH_NEW, params=params, **extra)
            fired = expert_straggler(eng, MESH_STRAGGLE)
            seen = watch_logits(eng)
            prefill = time_prefill(eng)
            ptrs, inner = set(), eng.model.decode_step

            def decode_step(p, state, tokens, inner=inner, ptrs=ptrs,
                            prefill=prefill):
                out = inner(p, state, tokens)
                ptrs.add((prefill["calls"], tuple(
                    local(t).data_ptr() for t in state["cache"].values())))
                return out

            eng.model.decode_step = decode_step
            reset_launches()
            t0 = time.monotonic()
            eng.run()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = read_launches()
            moe = eng.params["layers"]["moe"]
            runs[label] = dict(
                streams={r.rid: r.out_tokens for r in eng.finished},
                log=[tuple(e[k] for k in ("step", "n_migrations",
                                          "mig_bytes", "applied",
                                          "n_expert_migrations",
                                          "expert_mig_bytes",
                                          "expert_applied"))
                     for e in eng.migration_log],
                launches=launches, wall=wall, ptrs=ptrs, fired=fired,
                steps=eng.decode_steps, metrics=path_metrics(eng, wall),
                waves=prefill["calls"], finite=bool(seen["finite"].item()),
                experts=(is_dtensor(moe["w_gate"]),
                         tuple(local(moe["w_gate"]).shape)),
                exchange=list(eng.exchange_log),
                peak=torch.cuda.max_memory_allocated() / 1e9)
            log_split(eng, wall, prefill)
            del eng, seen, moe
            release()
    del params
    one, mesh = runs["unsharded"], runs["mesh"]
    ring = mesh["launches"]["decode_attention_ring_resident"]
    heads = [e for e in mesh["log"] if e[3] and e[1]]
    experts = [e for e in mesh["log"] if e[6] and e[4]]
    log(f"mesh (1, 1, 1) mixtral-8x7b x{N_LAYERS} bf16 ring (wave engine): "
        f"{len(mesh['streams'])} requests in {mesh['waves']} waves, "
        f"{mesh['steps']} decode steps in {mesh['wall']:.2f} s "
        f"({mesh['metrics']['tok/s']:.1f} tok/s; unsharded "
        f"{one['metrics']['tok/s']:.1f}); decode step median "
        f"{mesh['metrics']['step median ms']:.2f} ms (unsharded "
        f"{one['metrics']['step median ms']:.2f}); controller intervals "
        f"mean {mesh['metrics']['interval mean ms']:.1f} ms (unsharded "
        f"{one['metrics']['interval mean ms']:.1f}); straggler at step "
        f"{mesh['fired']}; {len(heads)} intervals applied head migrations, "
        f"{len(experts)} expert migrations ({sum(e[4] for e in experts)} "
        f"rows, {sum(e[5] for e in experts) / 1e6:.1f} MB priced); sent to "
        f"other ranks {mesh['exchange']}; local expert stack "
        f"{mesh['experts'][1]}; launches "
        f"{ {k: v for k, v in mesh['launches'].items() if v} }; peak memory "
        f"{mesh['peak']:.2f} GB (unsharded {one['peak']:.2f})")
    check(len(mesh["streams"]) == 8 and mesh["streams"] == one["streams"],
          "mesh mixtral: streams differ from the unsharded engine's")
    check(mesh["log"] == one["log"], "mesh mixtral: migration logs differ")
    check(bool(heads) and bool(experts),
          f"mesh mixtral: no head ({len(heads)}) or expert "
          f"({len(experts)}) migration applied")
    check(ring == mesh["steps"] * N_LAYERS,
          f"mesh mixtral: ring launches {ring} != decode steps "
          f"{mesh['steps']} x {N_LAYERS} layers")
    check(mesh["launches"]["flash_attention"] == mesh["waves"] * N_LAYERS
          and mesh["waves"] == 2, f"mesh mixtral: flash launches "
          f"{mesh['launches']['flash_attention']} for {mesh['waves']} "
          f"waves x {N_LAYERS} layers")
    check(not any(v for k, v in mesh["launches"].items()
                  if k not in ("decode_attention_ring_resident",
                               "flash_attention")),
          f"mesh mixtral: another kernel launched: {mesh['launches']}")
    check(len({w for w, _ in mesh["ptrs"]}) == len(mesh["ptrs"]) == 2,
          f"mesh mixtral: a ring buffer moved in memory within a wave "
          f"({len(mesh['ptrs'])} pointer sets)")
    check(mesh["experts"] == (True, (N_LAYERS, cfg.n_experts, cfg.d_model,
                                     cfg.d_ff)),
          f"mesh mixtral: expert stacks {mesh['experts']}")
    check(mesh["finite"] and one["finite"], "mesh mixtral: non-finite "
          "logits")
    return {"decode_attention_ring_resident": ring,
            "flash_attention": mesh["launches"]["flash_attention"]}


# ----------- the recurrent families on a DeviceMesh (tp-4 shards, (1, 1))
def head_slice(t, r, n, dim=1):
    """Rank ``r``'s ``n`` heads of ``t`` along ``dim`` as the rank holds
    them: its own contiguous tensor, seen through ``t``'s layout (a
    transposed view stays a transposed view of the rank's activations)."""
    part = t.narrow(dim, r * n, n)
    if dim == 1 and t.dim() == 4 and t.stride(1) < t.stride(2):
        # a (B, H, S, dh) view of (B, S, H, dh) memory
        return part.transpose(1, 2).contiguous().transpose(1, 2)
    return part.contiguous()


def wkv6_head_shards():
    """The WKV6 kernel on the tp-4 head shards of rwkv6-7b at published
    widths (B 8, 64 heads of 64, a shard 16), as a rank's model runs it:
    r/k/v/w transposed views of the rank's own (B, S, 16, dh) activations,
    its rows of u and its contiguous state shard, written in place
    (``out_state``).  At S 1 (the per-step body) and S 1024 (the chunked
    body), f32 and bf16, smooth and extreme decays: each shard held to its
    plain version at RWKV_TOL, and the four shards put together to the
    whole call (y and the final state) — heads do not interact, so bit for
    bit is expected, and the gap is logged either way.  Then one shard's
    call timed against the whole call (bf16), beside its bound: a shard
    reads a quarter of the state bytes.  Comparison launches: not counted.
    Returns {shape label: (ms a shard, ms the whole call, bound ms)}."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked as kern
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_plain as plain
    n = RWKV_H // SHARDS
    failed, times = [], {}
    for S in (1, RWKV_PROMPT):
        for i, (dt, decays) in enumerate(
                (dt, d) for dt in (torch.float32, torch.bfloat16)
                for d in ("smooth", "extreme")):
            args = rwkv6_inputs(dt, S=S, seed=40 + i, decays=decays)
            y, s = kern(*args)
            ys, states, worst = [], [], 0.0
            for r in range(SHARDS):
                sargs = tuple(head_slice(t, r, n, dim=0 if t.dim() == 2
                                         else 1) for t in args)
                out_y, out_s = kern(*sargs, out_state=sargs[5])
                torch.cuda.synchronize()
                want_y, want_s = plain(*tuple(head_slice(t, r, n, dim=0 if
                                              t.dim() == 2 else 1)
                                              for t in args))
                worst = max(worst, (out_y - want_y).abs().max().item(),
                            (out_s - want_s).abs().max().item())
                if not (torch.allclose(out_y, want_y, **RWKV_TOL)
                        and torch.allclose(out_s, want_s, **RWKV_TOL)
                        and out_s.data_ptr() == sargs[5].data_ptr()):
                    failed.append(f"S={S} {str(dt)[6:]} {decays} shard {r}")
                ys.append(out_y)
                states.append(out_s)
            together = (torch.cat(ys, dim=1), torch.cat(states, dim=1))
            same = torch.equal(together[0], y) and \
                torch.equal(together[1], s)
            gap = max((together[0] - y).abs().max().item(),
                      (together[1] - s).abs().max().item())
            if not (torch.allclose(together[0], y, **RWKV_TOL)
                    and torch.allclose(together[1], s, **RWKV_TOL)):
                failed.append(f"S={S} {str(dt)[6:]} {decays}: shards put "
                              f"together vs the whole call ({gap:.3e})")
            log(f"rwkv6_chunked on the tp-4 head shards ({SHARDS} x {n} of "
                f"{RWKV_H} heads) {str(dt)[6:]:8s} B={RWKV_B} S={S:4d} "
                f"{decays:7s} decays: worst gap to the plain version "
                f"{worst:.3e}; shards put together vs the whole call: "
                f"{'bit-equal' if same else f'max_abs_err={gap:.3e}'}")
            del args, y, s, ys, states, together
        # timing: the four shards' calls (distinct memory, a rank each)
        # against the whole call's, both bf16 with the state in place
        whole = [rwkv6_inputs(torch.bfloat16, S=S, seed=60 + c)
                 for c in range(8 if S == 1 else 1)]
        shards = [tuple(head_slice(t, r, n, dim=0 if t.dim() == 2 else 1)
                        for t in whole[0]) for r in range(SHARDS)]
        reps = (20, 50) if S == 1 else (4, 10)
        ms_whole = cuda_ms([lambda a=a: kern(*a, out_state=a[5])
                            for a in whole], *reps)
        ms_shard = cuda_ms([lambda a=a: kern(*a, out_state=a[5])
                            for a in shards], *reps)
        bound, bound_by = rwkv6_bound_ms(shards[0][0], shards[0][3],
                                         shards[0][4], shards[0][5])
        bound_whole, _ = rwkv6_bound_ms(whole[0][0], whole[0][3],
                                        whole[0][4], whole[0][5])
        times[f"S={S}"] = (ms_shard, ms_whole, bound)
        log(f"rwkv6_chunked bf16 S={S} on a tp-4 head shard ({n} heads): "
            f"{ms_shard:.4f} ms (bound {bound:.4f} ms, {bound_by}) against "
            f"{ms_whole:.4f} ms the whole call of {RWKV_H} heads (bound "
            f"{bound_whole:.4f} ms): a shard takes "
            f"{ms_shard / ms_whole:.2f} of the whole call's time for a "
            f"quarter of its work")
        del whole, shards
        release()
    check(not failed, "rwkv6 head shards: " + "; ".join(failed[:6]))
    return times


def zamba2_shared_block_shards():
    """Zamba2's shared attention block on the tp-4 head shards at
    zamba2-2.7b's widths (32 heads of 80 over 32 KV heads, G 1; a shard 8
    over 8), as a rank's model runs it on its own contiguous activations
    and cache shard: the flash kernel at the lock-step wave's prefill (B
    8, S 1024, causal) and the resident decode kernel over identity rows
    at the wave's extent (T 1096) with the lock-step and a mixed set of
    lengths.  Each shard held to its plain version, the four put together
    to the whole call, at the kernel phases' bounds (TOLS, FLASH_ROW_REL,
    DECODE_ROW_REL); f32 and bf16.  Then one shard's call timed against
    the whole call (bf16).  Comparison launches: not counted."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_resident as dec,
        decode_attention_resident_plain as dec_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    H, dh = ZAMBA_DECODE["H"], ZAMBA_DECODE["dh"]
    n = H // SHARDS
    rows = torch.arange(n, dtype=torch.int32, device="cuda")
    failed = []

    def flash_shard(args, r):
        return tuple(head_slice(t, r, n) for t in args)

    def dec_shard(args, r):
        q, k, v, lens, _ = args
        return (head_slice(q, r, n), head_slice(k, r, n),
                head_slice(v, r, n), lens, rows)

    cases = [("flash", dt, lambda dt=dt: flash_inputs(
        dt, B=ZAMBA_B, H=H, KvE=H, Sq=ZAMBA_PROMPT, dh=dh, seed=70),
        lambda a: flash_attention(*a, causal=True),
        lambda a: flash_attention_plain(*a, causal=True), flash_shard,
        FLASH_ROW_REL[dt]) for dt in (torch.float32, torch.bfloat16)]
    cases += [(f"resident {label}", dt, lambda dt=dt, lens=lens:
               decode_inputs(dt, seed=71, lengths=lens, **ZAMBA_DECODE),
               lambda a: dec(*a), lambda a: dec_plain(*a), dec_shard,
               DECODE_ROW_REL[dt])
              for dt in (torch.float32, torch.bfloat16)
              for label, lens in (("lock-step", ZAMBA_LOCKSTEP),
                                  ("mixed", ZAMBA_MIXED))]
    times = {}
    for label, dt, inputs, kern, plain, cut, limit in cases:
        args = inputs()
        whole = kern(args)
        parts, worst = [], 0.0
        for r in range(SHARDS):
            sargs = cut(args, r)
            out = kern(sargs)
            want = plain(sargs)
            rel = row_rel_err(out, want)
            worst = max(worst, rel)
            if not (torch.allclose(out.float(), want.float(), **TOLS[dt])
                    and rel <= limit):
                failed.append(f"{label} {dt} shard {r} vs plain "
                              f"({rel:.3e})")
            parts.append(out)
        together = torch.cat(parts, dim=1)
        rel_whole = row_rel_err(together, whole)
        if not (torch.allclose(together.float(), whole.float(), **TOLS[dt])
                and rel_whole <= limit):
            failed.append(f"{label} {dt}: shards put together vs the whole "
                          f"call ({rel_whole:.3e})")
        log(f"zamba2 shared block {label} on the tp-4 head shards ({SHARDS} "
            f"x {n} of {H} heads, dh {dh}) {str(dt)[6:]}: worst per-row "
            f"relative gap to the plain version {worst:.3e}, of the shards "
            f"put together to the whole call {rel_whole:.3e}"
            f"{' (bit-equal)' if torch.equal(together, whole) else ''} "
            f"(limit {limit:.0e})")
        if dt == torch.bfloat16:
            shards = [cut(args, r) for r in range(SHARDS)]
            reps = (20, 50) if label != "flash" else (4, 10)
            ms_whole = cuda_ms([lambda: kern(args)], *reps)
            ms_shard = cuda_ms([lambda a=a: kern(a) for a in shards], *reps)
            times[label] = (ms_shard, ms_whole)
            log(f"  bf16 {ms_shard:.4f} ms a shard against {ms_whole:.4f} "
                f"ms the whole call")
            del shards
        del args, whole, parts, together
        release()
    check(not failed, "zamba2 shared block shards: " + "; ".join(failed[:6]))
    return times


def phase_mesh_ssm_serving():
    """``make_engine(mode="auto", part=..., use_kernel=True)`` on a (1, 1)
    ("data", "model") NCCL mesh for the recurrent families at published
    widths, bf16: rwkv6-7b at 4 layers (``nonzero_adapters``) and
    zamba2-2.7b at 2 of its 9 supergroups (``seed_ssm_params``), each
    serving 16 requests of 256-token prompts (2 waves of 8), 32 new
    tokens each, λ 8, a 500x head straggler at step 8; params placed by
    ``param_shardings``, states by ``decode_state_shardings``.  The same
    weights and traffic run first through the unsharded engine.  The
    sharded engine's kernel counts are set to 0 just before it is driven
    and read just after.  Checks: the wave engine, greedy streams and
    migration logs equal to the unsharded engine's, plans logged as not
    applied with the reference's reason and nothing sent to another rank,
    the states' local shards written in place (one ``data_ptr`` per state
    leaf over a wave's decode steps), launches exact — WKV6 == (decode
    steps + prefills) x layers; zamba2's resident kernel == decode steps x
    supergroups, flash == waves x supergroups — and no other kernel.
    Logs peak memory and the eager step median against the unsharded
    engine's.  Returns the launches by kernel."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import (is_dtensor, local,
                                                 make_partitioner)
    from repro_torch.serving.engine import WaveServingEngine
    from repro_torch.tree import flatten
    from repro_torch.configs import get_config
    prompt, new, n_req = 256, 32, 16
    families = {
        "rwkv6": (get_config("rwkv6-7b").with_overrides(n_layers=N_LAYERS),
                  nonzero_adapters, rwkv6_engine, NO_HEADS),
        "zamba2": (zamba2_cfg(), seed_ssm_params, zamba2_engine, NO_CACHE),
    }
    added = {"rwkv6_chunked": 0, "decode_attention_resident": 0,
             "flash_attention": 0}
    with one_rank_nccl():
        part = make_partitioner(make_debug_mesh(1, 1))
        for fam, (cfg, seed_params, make, reason) in families.items():
            params = build_model(cfg, device="cuda").init(
                # rpr: ignore[RPR001] -- another model's weights, from seed 0
                torch.Generator(device="cuda").manual_seed(0))
            seed_params(params)
            runs = {}
            for label, extra in (("unsharded", {}),
                                 ("mesh", dict(part=part))):
                torch.cuda.reset_peak_memory_stats()
                eng = make(cfg, use_kernel=True, n_requests=n_req,
                           prompt=prompt, max_new=new, params=params,
                           max_seq=prompt + new + 8, **extra)
                fired = head_straggler(eng, 8)
                seen = watch_logits(eng)
                prefill = time_prefill(eng)
                ptrs, inner = set(), eng.model.decode_step

                def decode_step(p, state, tokens, inner=inner, ptrs=ptrs,
                                prefill=prefill):
                    out = inner(p, state, tokens)
                    ptrs.add((prefill["calls"], tuple(
                        local(t).data_ptr()
                        for t in flatten(state["cache"]).values()
                        if t is not None)))
                    return out

                eng.model.decode_step = decode_step
                reset_launches()
                rwkv6_chunked.launches = 0
                t0 = time.monotonic()
                eng.run()
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                launches = read_launches()
                launches["rwkv6_chunked"] = rwkv6_chunked.launches
                leaves = flatten(eng.params)
                runs[label] = dict(
                    type=type(eng).__name__,
                    streams={r.rid: r.out_tokens for r in eng.finished},
                    log=[tuple(e[k] for k in ("step", "n_migrations",
                                              "mig_bytes", "applied",
                                              "reason"))
                         for e in eng.migration_log],
                    launches=launches, wall=wall, ptrs=ptrs, fired=fired,
                    steps=eng.decode_steps, waves=prefill["calls"],
                    metrics=path_metrics(eng, wall),
                    finite=bool(seen["finite"].item()),
                    placed=all(is_dtensor(t) for t in leaves.values()),
                    exchange=list(eng.exchange_log),
                    peak=torch.cuda.max_memory_allocated() / 1e9)
                log_split(eng, wall, prefill)
                del eng, seen, leaves
                release()
            del params
            one, mesh = runs["unsharded"], runs["mesh"]
            L = cfg.n_layers if fam == "rwkv6" else cfg.n_layers \
                // cfg.shared_attn_every
            got = {k: v for k, v in mesh["launches"].items() if v}
            if fam == "rwkv6":
                want = {"rwkv6_chunked": (mesh["steps"] + mesh["waves"]) * L}
            else:
                want = {"decode_attention_resident": mesh["steps"] * L,
                        "flash_attention": mesh["waves"] * L}
            planned = [e for e in mesh["log"] if e[1]]
            log(f"mesh (1, 1) {fam} {cfg.name} x{cfg.n_layers} layers bf16 "
                f"({mesh['type']}): {len(mesh['streams'])} requests in "
                f"{mesh['waves']} waves, {mesh['steps']} decode steps in "
                f"{mesh['wall']:.2f} s ({mesh['metrics']['tok/s']:.1f} tok/s;"
                f" unsharded {one['metrics']['tok/s']:.1f}); decode step "
                f"median {mesh['metrics']['step median ms']:.2f} ms "
                f"(unsharded {one['metrics']['step median ms']:.2f}, "
                f"{mesh['metrics']['step median ms'] / one['metrics']['step median ms']:.2f}"
                f"x); controller intervals mean "
                f"{mesh['metrics']['interval mean ms']:.1f} ms (unsharded "
                f"{one['metrics']['interval mean ms']:.1f}); straggler at "
                f"step {mesh['fired']}; "
                f"{len(planned)} intervals planned head moves, none applied; "
                f"sent to other ranks {mesh['exchange']}; launches {got}; "
                f"peak memory {mesh['peak']:.2f} GB (unsharded "
                f"{one['peak']:.2f})")
            check(mesh["type"] == one["type"] == "WaveServingEngine",
                  f"mesh {fam}: make_engine picked {mesh['type']}")
            check(len(mesh["streams"]) == n_req
                  and mesh["streams"] == one["streams"]
                  and all(len(t) == new for t in mesh["streams"].values()),
                  f"mesh {fam}: streams differ from the unsharded engine's")
            check(mesh["log"] == one["log"], f"mesh {fam}: logs differ")
            check(bool(planned) and all(not e[3] and e[4] == reason
                                        for e in planned)
                  and not mesh["exchange"] and mesh["placed"],
                  f"mesh {fam}: a plan applied, a row was sent or a weight "
                  f"was not placed")
            check(got == want, f"mesh {fam}: launches {got} != {want}")
            check(one["launches"] == mesh["launches"],
                  f"mesh {fam}: launches differ from the unsharded engine's "
                  f"({one['launches']})")
            check(len({w for w, _ in mesh["ptrs"]}) == len(mesh["ptrs"])
                  == mesh["waves"] == 2,
                  f"mesh {fam}: a state shard moved in memory within a wave "
                  f"({len(mesh['ptrs'])} pointer sets)")
            check(mesh["finite"] and one["finite"],
                  f"mesh {fam}: non-finite logits")
            for name, v in want.items():
                added[name] += v
            del runs
            release()
    return added


def mesh_buffers(state) -> dict:
    """{name: local shard} of a decode state's cache and image K/V."""
    from repro_torch.models.partitioning import local
    out = {f"cache/{n}": local(t) for n, t in state["cache"].items()}
    out.update({f"img_kv/{n}": local(t)
                for n, t in state.get("img_kv", {}).items()})
    return out


def local_tree(tree):
    """A nested dict of DTensors as their local shards."""
    from repro_torch.models.partitioning import local
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    return local(tree)


def image_kv_gap(eng) -> float:
    """After a VLM engine's run: the worst gap between its image K/V
    shard and ``layers.project_kv`` of its cross layers' current (so
    permuted) weights on the image of the request each slot last held,
    over every cross layer, slot and position.  Migrations permute the
    image K/V in place after admission projected it; projection commutes
    with the head permutation, so the two agree to bf16 rounding."""
    from repro_torch.models import layers as L
    from repro_torch.models.partitioning import local
    from repro_torch.models.transformer import _layer_view
    last = {e["slot"]: e["rid"] for e in eng.admission_log}
    reqs = {r.rid: r for r in eng.finished}
    cross = local_tree(eng.params["cross_layers"])
    dt = local(eng.state["img_kv"]["k"]).dtype
    worst = 0.0
    for g in range(eng.model.n_groups):
        p = _layer_view(cross, g)["attn"]
        for slot, rid in last.items():
            img = torch.as_tensor(reqs[rid].img, device="cuda").to(dt)
            want = L.project_kv(eng.cfg, p, eng.model.hd, img[None])
            for n in ("k", "v"):
                got = local(eng.state["img_kv"][n])[g, slot]
                worst = max(worst, (got.float() - want[n][0].float())
                            .abs().max().item())
    return worst


def phase_mesh_audio_vlm_serving():
    """``make_engine(mode="auto", part=..., use_kernel=True)`` on a (1, 1)
    ("data", "model") NCCL mesh for the audio and VLM families at
    published widths, bf16: musicgen-large at 4 layers
    (``random_norm_mlp_bias``) and llama-3.2-vision-11b at 2 supergroups
    (8 self + 2 gated cross layers, ``set_vlm_gates``; image buffers of
    ``VLM_IMG`` rows, "columns"), each serving ``MESH_REQUESTS`` requests
    of 32-512 tokens (the VLM's with images of 1601, 1025 and 0 rows in
    turn), ``MESH_NEW`` new tokens each, 8 slots, an extent of 1024, λ 8,
    a 500x straggler at step ``MESH_STRAGGLE``; params placed by
    ``param_shardings``, the cache and image K/V by
    ``decode_state_shardings``.  The same weights and traffic run first
    through the unsharded engine.  The sharded engine's kernel counts are
    set to 0 just before it is driven and read just after.  Checks: the
    continuous engine (no fallback to the wave engine), greedy streams and
    migration logs equal to the unsharded engine's, an applied migration,
    the local shards of the cache and the image K/V written in place (one
    ``data_ptr`` per buffer over every decode step, migrations included),
    after the run the image K/V shard equal to ``project_kv`` of the
    permuted cross weights on the same images (``image_kv_gap``, within
    TOLS's bf16 atol), launches exact — musicgen: resident == decode
    steps x 4, flash == admissions x 4; the VLM: resident == decode steps
    x 10 (8 self layers over the cache, 2 cross layers over the image
    K/V), flash == admissions x 8 self layers — and no other kernel.
    Logs peak memory and the eager step median against the unsharded
    engine's.  Returns the launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import is_dtensor, make_partitioner
    from repro_torch.serving.engine import make_engine
    from repro_torch.tree import flatten
    families = {
        "musicgen": (get_config("musicgen-large").with_overrides(
            n_layers=N_LAYERS), random_norm_mlp_bias, {}, N_LAYERS),
        "vlm": (get_config("llama-3.2-vision-11b").with_overrides(
            n_layers=VLM_LAYERS), set_vlm_gates,
            dict(img_tokens=VLM_IMG, layer_mode="columns"), VLM_SELF),
    }
    added = {"decode_attention_resident": 0, "flash_attention": 0}
    keys = ("step", "n_migrations", "mig_bytes", "applied", "reason")
    with one_rank_nccl():
        part = make_partitioner(make_debug_mesh(1, 1))
        for fam, (cfg, seed_params, kw, n_self) in families.items():
            params = build_model(cfg, device="cuda").init(
                # rpr: ignore[RPR001] -- another model's weights, from seed 0
                torch.Generator(device="cuda").manual_seed(0))
            seed_params(params)
            imgs = vlm_images(MESH_REQUESTS, cfg.d_model) if fam == "vlm" \
                else [None] * MESH_REQUESTS
            runs = {}
            for label, extra in (("unsharded", {}),
                                 ("mesh", dict(part=part))):
                torch.cuda.reset_peak_memory_stats()
                eng = make_engine(
                    cfg, mode="auto", n_slots=MAIN_B, max_seq=MAIN_T,
                    lam=8, seed=0, net=DeviceNetwork.sample(4, seed=1),
                    use_kernel=True, params=params, device="cuda", **kw,
                    **extra)
                for p, img in zip(traffic(MESH_REQUESTS, cfg.vocab_size),
                                  imgs):
                    eng.submit(p, max_new_tokens=MESH_NEW,
                               **({} if img is None
                                  else dict(img_embeds=img)))
                ptrs = {n: {t.data_ptr()}
                        for n, t in mesh_buffers(eng.state).items()}
                seen = watch_logits(eng)
                prefill = time_prefill(eng)
                reset_launches()
                t0 = time.monotonic()
                while drive(eng, straggle_at=MESH_STRAGGLE):
                    for n, t in mesh_buffers(eng.state).items():
                        ptrs[n].add(t.data_ptr())
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                launches = read_launches()
                runs[label] = dict(
                    type=type(eng).__name__,
                    streams={r.rid: r.out_tokens for r in eng.finished},
                    log=[tuple(e[k] for k in keys)
                         for e in eng.migration_log],
                    launches=launches, wall=wall, ptrs=ptrs,
                    steps=eng.decode_steps, admissions=prefill["calls"],
                    metrics=path_metrics(eng, wall),
                    finite=bool(seen["finite"].item()),
                    placed=all(is_dtensor(t) for t in
                               flatten(eng.params).values()),
                    shards={n: tuple(t.shape) for n, t in
                            mesh_buffers(eng.state).items()},
                    exchange=list(eng.exchange_log),
                    img_gap=image_kv_gap(eng) if fam == "vlm" else None,
                    peak=torch.cuda.max_memory_allocated() / 1e9)
                log_split(eng, wall, prefill)
                del eng, seen
                release()
            del params
            one, mesh = runs["unsharded"], runs["mesh"]
            got = {k: v for k, v in mesh["launches"].items() if v}
            want = {"decode_attention_resident": mesh["steps"]
                    * cfg.n_layers,
                    "flash_attention": mesh["admissions"] * n_self}
            applied = [e for e in mesh["log"] if e[1] and e[3]]
            ratio = mesh["metrics"]["step median ms"] \
                / one["metrics"]["step median ms"]
            log(f"mesh (1, 1) {fam} {cfg.name} x{cfg.n_layers} layers bf16 "
                f"({mesh['type']}): {len(mesh['streams'])} requests, "
                f"{mesh['admissions']} admissions, {mesh['steps']} decode "
                f"steps in {mesh['wall']:.2f} s "
                f"({mesh['metrics']['tok/s']:.1f} tok/s; unsharded "
                f"{one['metrics']['tok/s']:.1f}); decode step median "
                f"{mesh['metrics']['step median ms']:.2f} ms (unsharded "
                f"{one['metrics']['step median ms']:.2f}, {ratio:.2f}x); "
                f"controller intervals mean "
                f"{mesh['metrics']['interval mean ms']:.1f} ms; "
                f"{len(applied)} applied migrations; local shards "
                f"{mesh['shards']}; sent to other ranks {mesh['exchange']}; "
                f"launches {got}; peak memory {mesh['peak']:.2f} GB "
                f"(unsharded {one['peak']:.2f})"
                + ("" if mesh["img_gap"] is None else
                   f"; image K/V shard vs project_kv of the permuted cross "
                   f"weights: max gap {mesh['img_gap']:.3e}"))
            check(mesh["type"] == one["type"] == "ServingEngine",
                  f"mesh {fam}: make_engine picked {mesh['type']}")
            check(len(mesh["streams"]) == MESH_REQUESTS
                  and mesh["streams"] == one["streams"]
                  and all(len(t) == MESH_NEW
                          for t in mesh["streams"].values()),
                  f"mesh {fam}: streams differ from the unsharded engine's")
            check(mesh["log"] == one["log"], f"mesh {fam}: logs differ")
            check(bool(applied), f"mesh {fam}: no migration was applied")
            check(mesh["placed"], f"mesh {fam}: a weight was not placed")
            check(all(len(p) == 1 for p in mesh["ptrs"].values()),
                  f"mesh {fam}: a cache or image K/V shard moved in memory "
                  f"({ {n: len(p) for n, p in mesh['ptrs'].items()} })")
            check(got == want, f"mesh {fam}: launches {got} != {want}")
            check(one["launches"] == mesh["launches"],
                  f"mesh {fam}: launches differ from the unsharded engine's "
                  f"({one['launches']})")
            check(mesh["img_gap"] is None
                  or mesh["img_gap"] <= TOLS[torch.bfloat16]["atol"],
                  f"mesh {fam}: the image K/V shard is not project_kv of "
                  f"the permuted cross weights (gap {mesh['img_gap']})")
            check(mesh["finite"] and one["finite"],
                  f"mesh {fam}: non-finite logits")
            for name, v in want.items():
                added[name] += v
            del runs
            release()
    return added


# ------------- int8 weights and paged caches on a DeviceMesh (one card)
# lock-step runs on int8 weights: (rows, prompt, greedy decode steps)
MESH_INT8 = {"llama3-8b": (8, 512, 32), "zamba2-2.7b": (8, 1024, 16),
             "mixtral-8x7b": (RING_B, RING_PROMPT, 16)}
# the sharded model's bf16 logits against the unsharded model's on the
# same int8 weights, per row (a vocabulary of logits): the same local ops
# on one rank, so any gap is a rounding of another op order, far below a
# wrong shard (O(1) of a row's norm)
MESH_LOGIT_ROW_REL = 2e-2


def placed_params(params, cfg, mesh):
    """``params`` placed on ``mesh`` by ``param_shardings`` (an int8 leaf's
    ``q8`` and ``sc`` by their own specs); on a one-card mesh each DTensor
    holds the tensor itself."""
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.models.partitioning import place
    from repro_torch.tree import flatten, map_with_path
    sh = flatten(param_shardings(params, cfg, mesh))
    return map_with_path(lambda p, v: place(v, sh[p]), params)


def int8_leaves(tree):
    """The int8 leaves ({"q8", "sc"}) of a param tree."""
    if isinstance(tree, dict) and "q8" in tree:
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in int8_leaves(v)]
    return []


def lockstep_run(model, params, tokens, steps, feed=None):
    """A lock-step prefill of ``tokens`` and ``steps`` decode steps, fed
    the greedy tokens (``feed``'s, when given: the same inputs as the run
    they are compared with).  Returns the logits of every call."""
    B, S = tokens.shape
    state = model.init_decode_state(params, B, S + steps)
    logits, state = model.prefill(params, state, tokens)
    out = [logits]
    for s in range(steps):
        nxt = feed[s].argmax(-1) if feed is not None else logits.argmax(-1)
        logits, state = model.decode_step(params, state, nxt)
        out.append(logits)
    torch.cuda.synchronize()
    return out


def phase_mesh_int8_weights():
    """The reference's ``quant_serve`` cell on one card: int8 weights
    placed by ``param_shardings`` (tp-resident, no fsdp), no engine (the
    engines take no int8 weights, as the reference's), on a one-rank NCCL
    mesh.  llama3-8b at published widths and all 32 layers (drawn a layer
    at a time by ``int8_layerwise``) and zamba2-2.7b's 54 layers (its
    embedding, head and shared block int8; SSM parameters seeded) on a
    (1, 1) ("data", "model") mesh, mixtral-8x7b at published widths, 4
    layers, on a (1, 1, 1) ("pod", "data", "model") mesh with dense and
    capacity dispatch over its 4096-slot ring.  Each runs ``MESH_INT8``'s
    lock-step prefill and greedy decode steps, first unsharded on the same
    int8 weights, then sharded, fed the unsharded run's tokens.  The
    sharded run's kernel counts are set to 0 just before it and read just
    after.  Checks: every placed int8 leaf is a DTensor whose local
    ``q8`` is int8; the greedy tokens are equal and every row of logits
    within ``MESH_LOGIT_ROW_REL``; launches exact — flash == one prefill x
    attention layers (zamba2: supergroups), the resident (mixtral: ring)
    kernel == steps x attention layers — and no other kernel; finite
    logits.  Logs weights and peak memory.  Returns the launches by
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import (is_dtensor, local,
                                                 make_partitioner)
    from repro_torch.models.quantization import quantize_params
    added = {}
    runs = [("llama3-8b", get_config("llama3-8b"), {}),
            ("zamba2-2.7b", zamba2_cfg(54), {}),
            ("mixtral-8x7b", get_config("mixtral-8x7b").with_overrides(
                n_layers=N_LAYERS), {}),
            ("mixtral-8x7b", get_config("mixtral-8x7b").with_overrides(
                n_layers=N_LAYERS), dict(capacity_moe=True))]
    with one_rank_nccl():
        params, drawn = None, None
        for name, cfg, kw in runs:
            if drawn != cfg.name + str(cfg.n_layers):
                params = None
                release()
                if cfg.family == "hybrid":
                    floats = build_model(cfg, device="cuda").init(
                        # rpr: ignore[RPR001] -- another model's weights, from seed 0
                        torch.Generator(device="cuda").manual_seed(0))
                    seed_ssm_params(floats)
                    params = quantize_params(floats)
                    del floats
                else:
                    params = int8_layerwise(cfg, "cuda", seed=0)
                drawn = cfg.name + str(cfg.n_layers)
            # the run's peak, apart from the weights' draw
            torch.cuda.reset_peak_memory_stats()
            held, bf16 = _weight_bytes(params)
            dims = ("pod", "data", "model") if cfg.is_moe \
                else ("data", "model")
            mesh = make_mesh((1,) * len(dims), dims)
            placed = placed_params(params, cfg, mesh)
            leaves = int8_leaves(placed)
            B, S, steps = MESH_INT8[name]
            # rpr: ignore[RPR001] -- this configuration's one input draw
            gen = torch.Generator(device="cuda").manual_seed(5)
            tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                   device="cuda")
            t0 = time.monotonic()
            want = lockstep_run(build_model(cfg, use_kernel=True,
                                            device="cuda", **kw),
                                params, tokens, steps)
            plain_s = time.monotonic() - t0
            release()
            reset_launches()
            t0 = time.monotonic()
            got = lockstep_run(build_model(cfg, use_kernel=True,
                                           device="cuda",
                                           part=make_partitioner(mesh),
                                           **kw),
                               placed, tokens, steps, feed=want)
            mesh_s = time.monotonic() - t0
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 1e9
            rel = max(row_rel_err(g, w) for g, w in zip(got, want))
            same = all(torch.equal(g.argmax(-1), w.argmax(-1))
                       for g, w in zip(got, want))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            attn = cfg.n_layers // cfg.shared_attn_every \
                if cfg.family == "hybrid" else cfg.n_layers
            decode = "decode_attention_ring_resident" if cfg.is_moe \
                else "decode_attention_resident"
            label = f"{cfg.name} x{cfg.n_layers}" + (
                " capacity" if kw else "")
            log(f"mesh int8 weights {label} on a {mesh.mesh.shape} "
                f"{dims} mesh: {len(leaves)} int8 leaves, weights "
                f"{held / 1e9:.2f} GB ({bf16 / 1e9:.2f} GB in bf16); "
                f"prefill {B} x {S} and {steps} greedy steps in "
                f"{mesh_s:.2f} s sharded, {plain_s:.2f} s unsharded; "
                f"logit row rel err {rel:.3e}, greedy tokens "
                f"{'equal' if same else 'DIFFER'}; launches "
                f"{ {k: v for k, v in launches.items() if v} }; peak "
                f"memory {peak:.2f} GB")
            check(bool(leaves) and all(
                is_dtensor(x["q8"]) and local(x["q8"]).dtype == torch.int8
                for x in leaves), f"mesh int8 {label}: an int8 leaf is not "
                f"a placed int8 DTensor")
            check(same and rel <= MESH_LOGIT_ROW_REL and finite,
                  f"mesh int8 {label}: tokens equal {same}, row rel err "
                  f"{rel:.3e}, finite {finite}")
            want_launches = {"flash_attention": attn,
                             decode: steps * attn}
            check({k: v for k, v in launches.items() if v}
                  == want_launches, f"mesh int8 {label}: launches "
                  f"{launches} != {want_launches}")
            for k, v in want_launches.items():
                added[k] = added.get(k, 0) + v
            del placed, leaves, want, got
            release()
        del params
    release()
    return added


def phase_mesh_paged_moe():
    """``ServingEngine(paged=True, part=..., use_kernel=True)`` for the MoE
    family on a (1, 1, 1) ("pod", "data", "model") NCCL mesh: a page pool
    for each batch rank (one here).  mixtral-8x7b at published widths, 4
    layers, bf16, without its sliding window (both packages keep windowed
    archs off paged caches; at ``MAIN_T`` 1024, below the 4096 window, the
    function is the same), pages of 64 and a pool of 48 (admission
    waits); 8 slots, the paged path's 16 requests of 32-512 tokens, 64
    new each, λ 8, a 500x straggler after step ``MESH_STRAGGLE`` on the
    device holding the most heads (its plan moves heads and experts; one
    on the device with the most expert blocks alone moves nothing on this
    traffic, the paged controller pricing page-rounded memory); from a
    bf16 and an int8 page store.  The
    unsharded paged engine serves the same weights and traffic first.
    The sharded engine's kernel counts are set to 0 just before it is
    driven and read just after.  Checks: the continuous engine; streams,
    admission logs, waits and migration logs equal to the unsharded
    engine's; an applied head or expert migration; each buffer of the
    local store written in place (one ``data_ptr`` over every decode
    step); paged (int8-paged) launches == decode steps x 4, flash 0, no
    other kernel.  Returns the launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import local, make_partitioner
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("mixtral-8x7b").with_overrides(n_layers=N_LAYERS,
                                                    sliding_window=0)
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    added = {}
    keys = ("step", "n_migrations", "mig_bytes", "applied",
            "n_expert_migrations", "expert_mig_bytes", "expert_applied")
    with one_rank_nccl():
        part = make_partitioner(make_mesh((1, 1, 1),
                                          ("pod", "data", "model")))
        for path in ("paged", "int8_paged"):
            name = PATHS[path][0]
            c = cfg.with_overrides(kv_quant=path == "int8_paged")
            runs = {}
            for label, extra in (("unsharded", {}), ("mesh", dict(part=part))):
                torch.cuda.reset_peak_memory_stats()
                eng = ServingEngine(
                    c, n_slots=MAIN_B, max_seq=MAIN_T, lam=8, seed=0,
                    net=DeviceNetwork.sample(4, seed=1), use_kernel=True,
                    device="cuda", params=params, paged=True, page_size=64,
                    kv_pages=48, **extra)
                for p in traffic(16, c.vocab_size):
                    eng.submit(p, max_new_tokens=64)
                seen = watch_logits(eng)
                prefill = time_prefill(eng)
                ptrs = {n: {local(t).data_ptr()}
                        for n, t in eng.state["cache"].items()}
                fired = []
                reset_launches()
                t0 = time.monotonic()
                while True:
                    if eng.decode_steps == MESH_STRAGGLE:
                        fired.append(MESH_STRAGGLE)
                    if not drive(eng, straggle_at=MESH_STRAGGLE):
                        break
                    for n, t in eng.state["cache"].items():
                        ptrs[n].add(local(t).data_ptr())
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                runs[label] = dict(
                    type=type(eng).__name__,
                    streams={r.rid: r.out_tokens for r in eng.finished},
                    admissions=list(eng.admission_log),
                    waits=(eng.page_waits, list(eng.rank_page_waits)),
                    log=[tuple(e[k] for k in keys)
                         for e in eng.migration_log],
                    launches=read_launches(), wall=wall, ptrs=ptrs,
                    steps=eng.decode_steps, fired=fired,
                    metrics=path_metrics(eng, wall),
                    store={n: tuple(local(t).shape)
                           for n, t in eng.state["cache"].items()},
                    drained=all(a.live_pages == 0 for a in eng.allocators),
                    finite=bool(seen["finite"].item()),
                    peak=torch.cuda.max_memory_allocated() / 1e9)
                log_split(eng, wall, prefill)
                del eng, seen
                release()
            one, mesh = runs["unsharded"], runs["mesh"]
            got = {k: v for k, v in mesh["launches"].items() if v}
            want = {name: mesh["steps"] * N_LAYERS}
            heads = [e for e in mesh["log"] if e[1] and e[3]]
            experts = [e for e in mesh["log"] if e[4] and e[6]]
            log(f"mesh (1, 1, 1) mixtral-8x7b x{N_LAYERS} {path} "
                f"({mesh['type']}, 48 pages of 64): "
                f"{len(mesh['streams'])} requests, {mesh['steps']} decode "
                f"steps in {mesh['wall']:.2f} s "
                f"({mesh['metrics']['tok/s']:.1f} tok/s; unsharded "
                f"{one['metrics']['tok/s']:.1f}); decode step median "
                f"{mesh['metrics']['step median ms']:.2f} ms (unsharded "
                f"{one['metrics']['step median ms']:.2f}); waits "
                f"{mesh['waits']}; straggler at step {mesh['fired']}; "
                f"{len(heads)} intervals applied head migrations, "
                f"{len(experts)} expert migrations; local store "
                f"{mesh['store']}; launches {got}; peak memory "
                f"{mesh['peak']:.2f} GB (unsharded {one['peak']:.2f})")
            check(mesh["type"] == "ServingEngine",
                  f"mesh paged moe {path}: built {mesh['type']}")
            check(len(mesh["streams"]) == 16
                  and mesh["streams"] == one["streams"],
                  f"mesh paged moe {path}: streams differ from the "
                  f"unsharded engine's")
            check(mesh["admissions"] == one["admissions"]
                  and mesh["waits"] == one["waits"]
                  and mesh["waits"][0] > 0,
                  f"mesh paged moe {path}: admissions or waits differ "
                  f"({mesh['waits']} against {one['waits']})")
            check(mesh["log"] == one["log"],
                  f"mesh paged moe {path}: migration logs differ")
            check(bool(heads or experts),
                  f"mesh paged moe {path}: no migration was applied")
            check(all(len(p) == 1 for p in mesh["ptrs"].values()),
                  f"mesh paged moe {path}: a store buffer moved in memory")
            check(got == want, f"mesh paged moe {path}: launches {got} != "
                  f"{want}")
            check(mesh["drained"] and one["drained"] and mesh["finite"]
                  and one["finite"], f"mesh paged moe {path}: pages live "
                  f"after the drain, or non-finite logits")
            added[name] = added.get(name, 0) + want[name]
            del runs
            release()
    del params
    release()
    return added


AUDIT_MIXTRAL_PROMPT = 512     # the ring audit's prompts (window 4096)
AUDIT_CHILD_TIMEOUT = 300


def captures_in_a_graph(fn) -> bool:
    """Whether ``fn()`` captures in a CUDA graph and replays (after one
    warm-up call on a side stream, as ``cuda_ms`` does): a host sync
    inside a kernel wrapper, which no dispatch mode sees, breaks the
    capture.  Raises what the capture raised."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return True


def audit_decode_step(label, model, params, state, tokens, kernel):
    """Checks one ``decode_step`` of a state the engine (or a lock-step
    prefill) filled: it runs under ``set_sync_debug_mode("error")``, where
    a host sync raises and nothing catches it, and launches ``kernel``
    once a layer; under ``trace_audit``'s dispatch mode it widens no
    cache-sized tensor (JXP001), reads nothing to the host (JXP002) and
    copies no cache or parameter (HLO002); every cache leaf keeps its
    storage (HLO001); the step raises the allocated peak by less than the
    cache's bytes; and it captures in a CUDA graph.  Returns the record
    logged for the path."""
    from repro_torch.analysis import step_audit, trace_audit
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    cache_b = step_audit.cache_bytes_of(state)
    big = trace_audit.big_elems_of(state["cache"]["k"])
    before = step_audit.cache_ptrs(state)
    step = getattr(da, kernel)
    torch.cuda.synchronize()
    launched = step.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, state = model.decode_step(params, state, tokens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launched = step.launches - launched
    (_, state), ops = trace_audit.record(model.decode_step, params, state,
                                         tokens)
    findings = trace_audit.audit_ops(ops, label, big_elems=big)
    findings += step_audit.copy_findings(
        label, ops, step_audit.storages(state, params), cache_b)
    findings += step_audit.check_in_place(label, before, state)
    rise = step_audit.memory_rise(model.decode_step, params, state, tokens)
    captured = captures_in_a_graph(
        lambda: model.decode_step(params, state, tokens))
    moved = step_audit.cache_ptrs(state) != before
    rec = dict(findings=[str(f) for f in findings], rise=rise,
               cache_bytes=cache_b, launched=launched, captured=captured,
               libraries=build.load.cache_info().currsize, moved=moved,
               ops=len(ops))
    log(f"audit {label}: {len(findings)} findings, {len(ops)} ops traced, "
        f"{kernel} launched {launched} times under the sync check, memory "
        f"rise {rise / 1e6:.3f} MB a step against the cache's "
        f"{cache_b / 1e6:.3f} MB, CUDA graph capture "
        f"{'held' if captured else 'FAILED'}, libraries loaded "
        f"{rec['libraries']}" + "".join(f"\n    {f}" for f in findings))
    check(not findings, f"audit {label}: {findings}")
    check(launched == model.cfg.n_layers, f"audit {label}: {kernel} "
          f"launched {launched} times, not once a layer")
    check(rise < cache_b, f"audit {label}: the step raised the peak by "
          f"{rise} B, at least the cache's {cache_b} B")
    check(not moved, f"audit {label}: a cache leaf moved over the checks")
    return rec


def prefill_ladder_on_the_card(eng):
    """HLO003 on the card: prompts of two lengths in each of the engine's
    buckets, each through the engine's own admission prefill (bucketed,
    through the flash kernel) into slot 0.  The distinct prefill traces
    must number the buckets, the flash kernel must launch once a layer a
    prefill, and the CUDA libraries loaded must not grow past the first
    prefill: no shape builds a library of its own."""
    from repro_torch.analysis import step_audit, trace_audit
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving.engine import Request
    m = eng.model
    inner = m.prefill_bucketed
    traces, libraries = set(), []

    def traced(*a):
        out, ops = trace_audit.record(inner, *a)
        traces.add(step_audit.trace_key(ops))
        return out

    rng = np.random.default_rng(0)
    lengths = [n for b in eng.buckets for n in (b // 2 + 1, b)]
    flash_attention.launches = 0
    m.prefill_bucketed = traced
    try:
        for n in lengths:
            eng._prefill_dense(0, Request(
                0, rng.integers(0, eng.cfg.vocab_size, n).astype(np.int32),
                1))
            libraries.append(build.load.cache_info().currsize)
    finally:
        del m.prefill_bucketed
    torch.cuda.synchronize()
    flash = flash_attention.launches
    log(f"audit prefill ladder: {len(lengths)} prompts of {lengths[0]}-"
        f"{lengths[-1]} tokens over buckets {list(eng.buckets)}: "
        f"{len(traces)} distinct prefill traces, flash_attention {flash} "
        f"launches, libraries loaded {libraries[0]} .. {libraries[-1]}")
    check(len(traces) == len(eng.buckets), f"audit ladder: {len(traces)} "
          f"prefill traces for {len(eng.buckets)} buckets")
    check(flash == len(lengths) * eng.cfg.n_layers, f"audit ladder: flash "
          f"launches {flash} != {len(lengths)} x {eng.cfg.n_layers}")
    check(len(set(libraries)) == 1, f"audit ladder: libraries loaded grew "
          f"with the bucket: {libraries}")
    return len(traces)


def phase_audit():
    """The hot-path audit on the card (``repro_torch.analysis``).  The
    main path's engine — llama3-8b at full width, 4 layers, 8 slots, a
    1024-token cache, bf16, ``use_kernel=True``, one set of seeded
    weights — from each cache kind (dense, paged, int8, int8-paged, so
    the four linear and paged decode kernels run): one scheduler step
    admits 8 requests (prefilled through flash) and decodes once, then
    ``audit_decode_step`` checks a decode step.  The 4-layer mixtral-8x7b
    at full width prefills 4 prompts of ``AUDIT_MIXTRAL_PROMPT`` tokens
    into its 4096-slot ring in lock-step, and its decode step through the
    ring kernel is checked the same way.  Then the dense engine's prefill
    ladder (``prefill_ladder_on_the_card``), and last the auditor's CLI as
    a child process on the card (``python -m repro_torch.analysis
    --device cuda``: the port's lints, the hot functions' trace and the
    step audit with the committed budgets), which must exit 0.  Any
    finding fails the phase.  Returns {path: record}."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    records = {}
    cfg = get_config("llama3-8b").with_overrides(n_layers=N_LAYERS)
    params = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    ladder_engine = None
    for path, (kernel, over, kw) in PATHS.items():
        eng = serve(cfg.with_overrides(**over), use_kernel=True,
                    n_requests=MAIN_B, max_new=64, params=params, **kw)
        eng.step()
        tokens = torch.as_tensor(eng._next, device="cuda")
        records[path] = audit_decode_step(path, eng.model, eng.params,
                                          eng.state, tokens, kernel)
        if path == "dense":
            ladder_engine = eng
        del eng
    records["ladder traces"] = prefill_ladder_on_the_card(ladder_engine)
    del ladder_engine, params
    release()
    mcfg = get_config("mixtral-8x7b").with_overrides(n_layers=N_LAYERS)
    model = build_model(mcfg, use_kernel=True, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    state = model.init_decode_state(params, RING_B, 2 * RING_W)
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, mcfg.vocab_size, (RING_B, AUDIT_MIXTRAL_PROMPT),
                           generator=gen, device="cuda")
    logits, state = model.prefill(params, state, prompt)
    check(state["cache"]["k"].shape[2] == RING_W, "audit mixtral: the state "
          "holds no ring")
    records["mixtral ring"] = audit_decode_step(
        "mixtral ring", model, params, state, logits.argmax(-1),
        "decode_attention_ring_resident")
    del model, params, state, logits
    release()
    t0 = time.monotonic()
    child = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True,
        timeout=AUDIT_CHILD_TIMEOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    out = child.stdout.strip().splitlines()
    log(f"audit CLI on the card: exit {child.returncode} in "
        f"{time.monotonic() - t0:.1f} s: " + " | ".join(out[-4:]))
    check(child.returncode == 0, f"audit CLI exited {child.returncode}:\n"
          f"{child.stdout[-3000:]}\n{child.stderr[-3000:]}")
    return records


# ------------------------------------------------------------ long-decode
# The reference's long_500k shape (``configs/base.py``: 524,288 tokens,
# batch 1, its dry-run's ``seq_over_data`` cells): a state as a prefill of
# 524,224 tokens leaves it, then 64 greedy steps to position 524,288.  The
# kernels' checks cut the sequence into 4 shards, as 4 data ranks would
# hold it; the models run on a (1, 1) mesh, where the one data rank holds
# every position and the merge has nothing to exchange.
LONG_T, LONG_STEPS, LONG_SHARDS = 524288, 64, 4
LONG_FILLED = LONG_T - LONG_STEPS
# zamba2's shared block: 32 q heads over 32 KV heads of 80, B 1; rows
# whose length ends in shard 0, 2 and 3
LONG_ZAMBA = dict(H=32, KvE=32, dh=80)
LONG_ZAMBA_LENGTHS = {"ends in shard 0": 100_000,
                      "ends in shard 2": 300_000, "whole": LONG_T}
# mixtral's ring: 32 q heads over 8 KV heads of 128 (G 4), B 1, a 4096-slot
# window wrapped at positions near 524,288, in 4 slot shards of 1024; the
# second row's window holds slots of shards 0 and 1 only
LONG_RING = dict(H=32, KvE=8, dh=128)
LONG_RING_LENGTHS = {"every slot": LONG_T, "shards 0-1": LONG_T - 3000}
# bf16 q is scaled and rounded before the tensor cores score it: the LSE of
# a bf16 call moves by up to a few 1e-2 against the plain version's
LONG_LSE_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
                torch.bfloat16: dict(atol=5e-2, rtol=0.0)}
# the f32 pairs at reduced depth: sharded against unsharded logits
LONG_F32_ATOL = 1e-5


def _spans(n: int, shards: int):
    """(lo, count) of each shard of ``n``, cut as ``torch.chunk`` (and so
    DTensor) cuts: the last may be short."""
    chunk = -(-n // shards)
    return [(min(r * chunk, n), max(min(chunk, n - r * chunk), 0))
            for r in range(shards)]


def long_inputs(dt, *, T, H, KvE, dh, seed, copies=1):
    """``copies`` sets of (q (1, H, dh), K/V (1, KvE, T, dh) views of a
    (1, T, KvE, dh) cache as the model keeps it), N(0, 1) drawn on the
    card from a seeded generator (the host would take minutes for a
    524,288-position cache)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(copies):
        q = torch.randn((1, H, dh), generator=gen, device="cuda").to(dt)
        kv = [torch.randn((1, T, KvE, dh), generator=gen, device="cuda",
                          dtype=dt).transpose(1, 2) for _ in range(2)]
        out.append((q, *kv))
    return out


def long_shards_vs_whole(label, dt, whole_fn, shard_fn, plain_fn, spans,
                         row_rel, failed):
    """One case of the whole-call-against-shards check: the existing entry
    point's output (``whole_fn()``); the same call with ``return_lse``
    merged alone, which must equal it bit for bit; each shard's (output,
    LSE) (``shard_fn(lo, n)``) against its plain version
    (``plain_fn(lo, n)``); and the shards' partials merged against the
    whole call.  Returns (worst shard row error, merged row error, shards
    whose LSE is empty)."""
    from repro_torch.models.partitioning import EMPTY_LSE, merge_partials
    whole = whole_fn()
    out, lse = whole_fn(return_lse=True)
    if not torch.equal(merge_partials(out[None], lse[None], dt), whole):
        failed.append(f"{label} {dt}: one shard merged alone is not the "
                      f"entry point's output bit for bit")
    parts, worst, empty = [], 0.0, []
    for r, (lo, n) in enumerate(spans):
        got, want = shard_fn(lo, n), plain_fn(lo, n)
        rel = row_rel_err(got[0], want[0])
        worst = max(worst, rel)
        if not (torch.allclose(got[0], want[0], **TOLS[dt])
                and rel <= row_rel
                and torch.allclose(got[1], want[1], **LONG_LSE_TOL[dt])):
            failed.append(f"{label} {dt} shard {r} vs plain ({rel:.3e}, "
                          f"LSE gap {(got[1] - want[1]).abs().max():.3e})")
        none = bool((got[1] == EMPTY_LSE).all())
        if none != bool((want[1] == EMPTY_LSE).all()) \
                or (none and bool(got[0].any())):
            failed.append(f"{label} {dt} shard {r}: an empty shard does "
                          f"not give zeros of LSE {EMPTY_LSE}")
        empty.append(none)
        parts.append(got)
    merged = merge_partials(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]), dt)
    rel = row_rel_err(merged, whole)
    if not (torch.allclose(merged.float(), whole.float(), **TOLS[dt])
            and rel <= row_rel):
        failed.append(f"{label} {dt}: the merged shards vs the whole call "
                      f"({rel:.3e})")
    return worst, rel, empty


def long_kernel_shards():
    """The two kernels this slice changed, at the long-decode shapes, on
    one card: the resident kernel with its LSE output over 4 sequence
    shards of zamba2's shared block (32 heads of 80, B 1, T 524,288 bf16,
    131,072 positions a shard; f32 at T 65,536) and the ring kernel over 4
    slot shards of 1024 of mixtral's 4096-slot window (8 KV heads of 128,
    G 4, B 1, positions near 524,288, wrapped; bf16 and f32): each shard
    against its plain version (TOLS, DECODE_ROW_REL or RING_ROW_REL, the
    LSE within LONG_LSE_TOL), the merged partials against the whole call,
    one shard merged alone against the existing entry point bit for bit,
    and shards past a row's length weighing nothing.  Then, in bf16, the
    whole call, a shard's LSE call, the merge and SDPA at the same shape
    timed, with the bound.  Comparison launches: not counted.  Returns
    {label: times}."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_resident as dec,
        decode_attention_resident_plain as dec_plain,
        decode_attention_ring_resident as ring,
        decode_attention_ring_resident_plain as ring_plain)
    from repro_torch.models.partitioning import SeqShard, merge_partials
    failed, times = [], {}
    # the resident kernel over sequence shards
    for dt, T in ((torch.float32, LONG_T // 8), (torch.bfloat16, LONG_T)):
        (q, k, v), = long_inputs(dt, T=T, seed=90, **LONG_ZAMBA)
        rows = torch.arange(LONG_ZAMBA["H"], dtype=torch.int32,
                            device="cuda")
        spans = _spans(T, LONG_SHARDS)
        for label, length in LONG_ZAMBA_LENGTHS.items():
            lens = torch.tensor([length * T // LONG_T], dtype=torch.int32,
                                device="cuda")

            def shard(lo, n, f=dec):
                seq = SeqShard(lo, n, T)
                return f(q, k[:, :, lo:lo + n], v[:, :, lo:lo + n],
                         seq.local_lengths(lens), rows, return_lse=True)

            worst, rel, empty = long_shards_vs_whole(
                f"resident {label}", dt,
                lambda **kw: dec(q, k, v, lens, rows, **kw), shard,
                lambda lo, n: shard(lo, n, dec_plain), spans,
                DECODE_ROW_REL[dt], failed)
            log(f"long-decode resident kernel {str(dt)[6:]} (zamba2's shared "
                f"block, T {T}, length {int(lens[0])}, {label}) over "
                f"{LONG_SHARDS} sequence shards: worst per-row gap of a "
                f"shard to its plain version {worst:.3e}, merged to the "
                f"whole call {rel:.3e} (limit {DECODE_ROW_REL[dt]:.0e}); "
                f"empty shards {empty}")
        if dt == torch.bfloat16:
            lens = torch.tensor([LONG_T], dtype=torch.int32, device="cuda")
            shards = [(k[:, :, lo:lo + n], v[:, :, lo:lo + n], lo, n)
                      for lo, n in spans]
            outs = [dec(q, sk, sv, SeqShard(lo, n, T).local_lengths(lens),
                        rows, return_lse=True) for sk, sv, lo, n in shards]
            stacked = (torch.stack([o[0] for o in outs]),
                       torch.stack([o[1] for o in outs]))
            reps = (4, 10)
            t = dict(
                ms=cuda_ms([lambda: dec(q, k, v, lens, rows)], *reps),
                lse_ms=cuda_ms([lambda: dec(q, k, v, lens, rows,
                                            return_lse=True)], *reps),
                shard_ms=cuda_ms([lambda s=s: dec(
                    q, s[0], s[1], SeqShard(s[2], s[3], T).local_lengths(
                        lens), rows, return_lse=True) for s in shards],
                    *reps),
                merge_ms=cuda_ms([lambda: merge_partials(*stacked, dt)]),
                plain_ms=cuda_ms([lambda: dec_plain(q, k, v, lens, rows)],
                                 1, 3),
                library_ms=cuda_ms([sdpa_decode(q, k, v, lens, rows)],
                                   *reps))
            t["bound_ms"], t["bound_by"] = decode_bound_ms(
                q, lens, rows, LONG_ZAMBA["KvE"], T)
            kv_gb = 2 * T * LONG_ZAMBA["KvE"] * LONG_ZAMBA["dh"] * 2 / 1e9
            t["shard_bound_ms"], _ = decode_bound_ms(
                q, lens.clamp(max=spans[0][1]), rows, LONG_ZAMBA["KvE"],
                spans[0][1])
            times["resident"] = t
            log(f"  bf16 at T {T}, length {LONG_T}: the whole call "
                f"{t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms, "
                f"{t['bound_by']}: {kv_gb:.2f} GB of K/V), "
                f"with its LSE {t['lse_ms']:.4f} ms; a shard's LSE call "
                f"{t['shard_ms']:.4f} ms (bound {t['shard_bound_ms']:.4f}); "
                f"the merge of {LONG_SHARDS} {t['merge_ms']:.4f} ms; plain "
                f"{t['plain_ms']:.4f} ms; SDPA (length mask) "
                f"{t['library_ms']:.4f} ms")
            del shards, outs, stacked
        del q, k, v
        release()
    # the ring kernel over slot shards
    W = RING_W
    spans = _spans(W, LONG_SHARDS)
    pos = torch.as_tensor(ring_slot_pos(W, LONG_T), dtype=torch.int32,
                          device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        sets = long_inputs(dt, T=W, seed=91, copies=8, **LONG_RING)
        q, k, v = sets[0]
        rows = torch.arange(LONG_RING["H"], dtype=torch.int32,
                            device="cuda")
        for label, length in LONG_RING_LENGTHS.items():
            lens = torch.tensor([length], dtype=torch.int32, device="cuda")

            def shard(lo, n, f=ring):
                return f(q, k[:, :, lo:lo + n], v[:, :, lo:lo + n], lens,
                         pos[lo:lo + n], rows, window=W, return_lse=True)

            worst, rel, empty = long_shards_vs_whole(
                f"ring {label}", dt,
                lambda **kw: ring(q, k, v, lens, pos, rows, window=W, **kw),
                shard, lambda lo, n: shard(lo, n, ring_plain), spans,
                RING_ROW_REL[dt], failed)
            log(f"long-decode ring kernel {str(dt)[6:]} (mixtral's window "
                f"{W}, length {length}, {label}) over {LONG_SHARDS} slot "
                f"shards of {spans[0][1]}: worst per-row gap of a shard to "
                f"its plain version {worst:.3e}, merged to the whole call "
                f"{rel:.3e} (limit {RING_ROW_REL[dt]:.0e}); empty shards "
                f"{empty}")
        if dt == torch.bfloat16:
            lens = torch.tensor([LONG_T], dtype=torch.int32, device="cuda")
            lo, n = spans[0]
            valid = ring_valid(lens, pos)
            mask = valid[:, None, None, :]
            t = dict(
                ms=cuda_ms([lambda s=s: ring(s[0], s[1], s[2], lens, pos,
                                             rows, window=W)
                            for s in sets]),
                shard_ms=cuda_ms([lambda s=s: ring(
                    s[0], s[1][:, :, lo:lo + n], s[2][:, :, lo:lo + n],
                    lens, pos[lo:lo + n], rows, window=W, return_lse=True)
                    for s in sets]),
                plain_ms=cuda_ms([lambda: ring_plain(q, k, v, lens, pos,
                                                     rows, window=W)], 2, 5),
                library_ms=cuda_ms([lambda s=s: torch.nn.functional
                                    .scaled_dot_product_attention(
                                        s[0][:, :, None], s[1], s[2],
                                        attn_mask=mask, enable_gqa=True)
                                    for s in sets]))
            t["bound_ms"], t["bound_by"] = decode_bound_ms(
                q, lens, rows, LONG_RING["KvE"], W,
                valid=int(valid.sum()), extra_bytes=4 * W)
            t["shard_bound_ms"], _ = decode_bound_ms(
                q, lens, rows, LONG_RING["KvE"], n,
                valid=int(valid[:, lo:lo + n].sum()), extra_bytes=4 * n)
            times["ring"] = t
            log(f"  bf16, every slot valid: the whole ring {t['ms']:.4f} ms "
                f"(bound {t['bound_ms']:.4f} ms, {t['bound_by']}); a slot "
                f"shard's LSE call {t['shard_ms']:.4f} ms (bound "
                f"{t['shard_bound_ms']:.4f}); plain {t['plain_ms']:.4f} ms; "
                f"SDPA (boolean mask) {t['library_ms']:.4f} ms")
        del sets, q, k, v
        release()
    check(not failed, "long-decode kernel shards: " + "; ".join(failed[:6]))
    return times


def long_first_token(cfg, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (1,), generator=gen,
                         device="cuda", dtype=torch.int32)


def fill_long_state(state, cfg, seed, T):
    """Seed a batch-1 decode state as a prefill of ``T - LONG_STEPS``
    tokens would leave it: a linear cache's positions [0, T - 64) N(0, 1)
    (later ones zero), a ring's 4096 slots holding the last 4096 positions
    as ``layers._ring_attention``'s fold leaves them (slot ``t % window``
    holds position t), the Mamba-2 conv tails and SSM states, RWKV-6's
    token shifts and WKV states seeded (0.5 N and 0.1 N), the lock-step
    position ``T - 64``.  Drawn on the card, leaf by leaf."""
    from repro_torch.tree import flatten
    gen = torch.Generator(device="cuda").manual_seed(seed)
    filled = T - LONG_STEPS
    scale = {"ssm": 0.1, "wkv": 0.1, "conv": 0.5, "shift_t": 0.5,
             "shift_c": 0.5}
    for path, t in flatten(state["cache"]).items():
        name = path[-1]
        if name == "pos":
            t.copy_(torch.as_tensor(ring_slot_pos(t.shape[-1], filled),
                                    dtype=t.dtype, device="cuda"))
        elif name in ("k", "v") and t.shape[-3] != cfg.sliding_window:
            t[..., :filled, :, :].normal_(generator=gen)
        else:
            t.normal_(generator=gen).mul_(scale.get(name, 1.0))
    state["pos"] = filled


def long_greedy(model, params, state, token, steps):
    """``steps`` greedy decode steps from ``state`` fed ``token`` first:
    (the logits of every step (steps, 1, V) float32 on the card, the
    tokens fed, each step's host-clock seconds ending in a sync, and each
    step's allocated-peak rise in bytes)."""
    logits, fed, secs, rises = [], [], [], []
    for _ in range(steps):
        fed.append(token)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out, state = model.decode_step(params, state, token)
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        rises.append(torch.cuda.max_memory_allocated() - base)
        logits.append(out.float())
        token = out.argmax(-1).to(torch.int32)
    return torch.stack(logits), torch.stack(fed), secs, rises


def long_decode_pair(label, cfg, params, dims, steps, T, seed, per_step):
    """The unsharded model and the same model on a one-rank NCCL mesh of
    ``dims`` under the long-decode rules (``make_partitioner(mesh,
    seq_over_data=True)``: batch whole, the cache's sequence — a ring's
    slots — over "data", heads over "model"), both with the kernels, on
    the same weights and the same seeded state (``fill_long_state``),
    ``steps`` greedy steps each.  The mesh model's kernel counts are set
    to 0 just before its run and read just after; ``per_step`` {kernel:
    launches a step} must match them, and ``SeqShard.merge`` must run once
    a step and attention layer (none for RWKV-6).  Returns a dict of the
    pair's results."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import partitioning
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import local, make_partitioner
    from repro_torch.tree import flatten
    mesh = make_mesh((1,) * len(dims), dims)
    part = make_partitioner(mesh, seq_over_data=True)
    plain = build_model(cfg, use_kernel=True, device="cuda")
    sharded = build_model(cfg, use_kernel=True, device="cuda", part=part)
    placed = placed_params(params, cfg, mesh)
    one = plain.init_decode_state(params, 1, T)
    fill_long_state(one, cfg, seed, T)
    two = sharded.init_decode_state(placed, 1, T)
    leaves = flatten(one["cache"])
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    seq_dims = {}
    for path, t in flatten(two["cache"]).items():
        local(t).copy_(leaves[path])
        names = tuple(t.device_mesh.mesh_dim_names)
        pl = t.placements[names.index("data")]
        seq_dims["/".join(path)] = pl.dim if pl.is_shard() else None
    two["pos"] = one["pos"]
    token = long_first_token(cfg, seed)
    torch.cuda.synchronize()
    want = long_greedy(plain, params, one, token, steps)
    del one
    release()
    merges, inner = [0], partitioning.SeqShard.merge

    def merge(self, out, lse, dtype=None):
        merges[0] += 1
        return inner(self, out, lse, dtype)

    collectives = []
    real = torch.distributed.all_reduce

    def all_reduce(t, *a, **kw):
        collectives.append(t.numel() * t.element_size())
        return real(t, *a, **kw)

    partitioning.SeqShard.merge = merge
    torch.distributed.all_reduce = all_reduce
    reset_launches()
    rwkv6_chunked.launches = 0
    try:
        got = long_greedy(sharded, placed, two, token, steps)
    finally:
        partitioning.SeqShard.merge = inner
        torch.distributed.all_reduce = real
    launches = read_launches()
    launches["rwkv6_chunked"] = rwkv6_chunked.launches
    launches = {k: n for k, n in launches.items() if n}
    rel = max(row_rel_err(g, w) for g, w in zip(got[0], want[0]))
    gap = (got[0] - want[0]).abs().max().item()
    same = torch.equal(got[1], want[1])
    finite = bool(torch.isfinite(got[0]).all())
    del two, placed, sharded, plain
    release()
    return dict(label=label, rel=rel, gap=gap, same=same, finite=finite,
                launches=launches, merges=merges[0], per_step=per_step,
                collectives=collectives, cache_bytes=cache_bytes,
                seq_dims=seq_dims,
                ms=(1e3 * float(np.median(want[2])),
                    1e3 * float(np.median(got[2]))),
                rise=(max(want[3]), max(got[3])), steps=steps)


def log_long_pair(r):
    log(f"long-decode {r['label']}: {r['steps']} greedy steps from position "
        f"{LONG_FILLED}: tokens {'equal' if r['same'] else 'DIFFER'}, "
        f"logits max gap {r['gap']:.3e} (row rel {r['rel']:.3e}); step "
        f"median {r['ms'][0]:.2f} ms unsharded, {r['ms'][1]:.2f} ms on the "
        f"mesh ({r['ms'][1] / r['ms'][0]:.2f}x); a step's allocated-peak "
        f"rise {r['rise'][0] / 1e6:.3f} / {r['rise'][1] / 1e6:.3f} MB "
        f"against the cache's {r['cache_bytes'] / 1e9:.3f} GB; launches "
        f"{r['launches']}; merges {r['merges']}; the step's collectives "
        f"{sum(r['collectives'])} B in {len(r['collectives'])} calls; the "
        f"state's \"data\" placements {r['seq_dims']}")


def phase_long_decode():
    """Long-decode (ROADMAP #18's ``seq_over_data``): the kernel checks
    (``long_kernel_shards``), then on one-rank NCCL meshes under
    ``make_partitioner(seq_over_data=True)``, each after the unsharded
    model on the same weights and state, 64 greedy steps from position
    524,224 at batch 1: zamba2-2.7b at published widths and 2 supergroups
    (12 Mamba-2 layers, the shared block twice a step over its (2, 1,
    524288, 32, 80) bf16 cache, 10.7 GB), mixtral-8x7b at published widths
    and 4 layers over its (4, 1, 4096, 8, 128) ring, rwkv6-7b x4; then f32
    pairs at reduced depth (zamba2 1 supergroup at T 65,536, mixtral and
    rwkv6 2 layers; 16 steps).  Checks: greedy streams equal, bf16 logit
    rows within MESH_LOGIT_ROW_REL and f32 logits within LONG_F32_ATOL,
    the cache's sequence placed over "data", the launches exact (resident
    == steps x supergroups, ring == steps x layers, WKV6 == steps x
    layers) with one merge a step and attention layer, and a step's
    allocated-peak rise under 10 % of a sequence-sharded cache's bytes
    (the merge gathers no cache; RWKV-6 has none).  Returns (the kernel
    times, the bf16 runs' launches by kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    times = long_kernel_shards()
    release()
    Z, R = ("data", "model"), ("pod", "data", "model")

    def zamba(n_layers, dtype):
        cfg = zamba2_cfg(n_layers=n_layers, dtype=dtype, param_dtype=dtype)
        params = build_model(cfg, device="cuda").init(
            # rpr: ignore[RPR001] -- another model's weights, from seed 0
            torch.Generator(device="cuda").manual_seed(0))
        seed_ssm_params(params)
        return cfg, params

    def mixtral(n_layers, dtype):
        cfg = get_config("mixtral-8x7b").with_overrides(
            n_layers=n_layers, dtype=dtype, param_dtype=dtype)
        return cfg, build_model(cfg, device="cuda").init(
            # rpr: ignore[RPR001] -- another model's weights, from seed 0
            torch.Generator(device="cuda").manual_seed(0))

    def rwkv(n_layers, dtype):
        cfg = get_config("rwkv6-7b").with_overrides(
            n_layers=n_layers, dtype=dtype, param_dtype=dtype)
        params = build_model(cfg, device="cuda").init(
            # rpr: ignore[RPR001] -- another model's weights, from seed 0
            torch.Generator(device="cuda").manual_seed(0))
        nonzero_adapters(params)
        return cfg, params

    runs = [  # label, model, layers, dtype, dims, steps, T, per-step kernel
        ("zamba2-2.7b x12 bf16", zamba, ZAMBA_LAYERS, "bfloat16", Z,
         LONG_STEPS, LONG_T, "decode_attention_resident"),
        ("mixtral-8x7b x4 bf16", mixtral, N_LAYERS, "bfloat16", R,
         LONG_STEPS, LONG_T, "decode_attention_ring_resident"),
        ("rwkv6-7b x4 bf16", rwkv, N_LAYERS, "bfloat16", Z, LONG_STEPS,
         LONG_T, "rwkv6_chunked"),
        ("zamba2-2.7b x6 f32", zamba, ZAMBA_EVERY, "float32", Z,
         LONG_STEPS // 4, LONG_T // 8, "decode_attention_resident"),
        ("mixtral-8x7b x2 f32", mixtral, 2, "float32", R, LONG_STEPS // 4,
         LONG_T, "decode_attention_ring_resident"),
        ("rwkv6-7b x2 f32", rwkv, 2, "float32", Z, LONG_STEPS // 4, LONG_T,
         "rwkv6_chunked"),
    ]
    added = {}
    with one_rank_nccl():
        for label, make, n_layers, dtype, dims, steps, T, kernel in runs:
            cfg, params = make(n_layers, dtype)
            attn = cfg.n_layers // cfg.shared_attn_every \
                if cfg.family == "hybrid" else cfg.n_layers
            r = long_decode_pair(label, cfg, params, dims, steps, T,
                                 seed=len(label), per_step={kernel: attn})
            del params
            release()
            log_long_pair(r)
            want = {kernel: steps * attn}
            merges = 0 if kernel == "rwkv6_chunked" else steps * attn
            seq = {p: d for p, d in r["seq_dims"].items()
                   if p.split("/")[-1] in ("k", "v")}
            f32 = dtype == "float32"
            check(r["same"] and r["finite"]
                  and (r["gap"] <= LONG_F32_ATOL if f32
                       else r["rel"] <= MESH_LOGIT_ROW_REL),
                  f"long-decode {label}: tokens equal {r['same']}, logit "
                  f"gap {r['gap']:.3e}, row rel {r['rel']:.3e}")
            check(r["launches"] == want and r["merges"] == merges,
                  f"long-decode {label}: launches {r['launches']} != {want}"
                  f" or merges {r['merges']} != {merges}")
            check(all(d is not None for d in seq.values()),
                  f"long-decode {label}: a cache's sequence is not placed "
                  f"over \"data\": {r['seq_dims']}")
            check(not seq or max(r["rise"]) <= 0.1 * r["cache_bytes"],
                  f"long-decode {label}: a step's memory rise {r['rise']} "
                  f"against a {r['cache_bytes']} B cache")
            if not f32:
                for k, n in want.items():
                    added[k] = added.get(k, 0) + n
            release()
    hd = dict(zamba2=(32, 80), mixtral=(32, 128))
    log("long-decode: on a data axis of d > 1 ranks, one layer's merge "
        "carries per rank the LSE of each q head (4 B), then each head's "
        "weighted output beside its weight (4 (dh + 1) B): "
        + ", ".join(f"{k} {4 * h + 4 * h * (dh + 1)} B a layer"
                    for k, (h, dh) in hd.items())
        + f"; a rank's K/V shard of zamba2's shared block at d = 4: "
        f"{2 * LONG_T // 4 * 32 * 80 * 2 / 1e9:.2f} GB, none of it sent")
    return times, added


def tp_phases(by_name):
    """The tp-16 phases, the one-card mesh, the decode kernels (and
    zamba2's shared block) on the tp-4 head shards, the WKV6 kernel on
    rwkv6-7b's, and sharded serving on the one-card mesh (dense, MoE over
    the ring, RWKV-6 and Zamba2, then musicgen and the VLM); their
    launches add to those kernels' records."""
    added = {"decode_attention_resident": 0, "flash_attention": 0}
    for phase in (phase_tp_dense, phase_tp_padded):
        launches = phase()
        for name in added:
            added[name] += launches[name]
        release()
    phase_tp_stream_pair()
    release()
    added["flash_attention"] += phase_mesh_one_card()
    release()
    phase_shard_kernels_vs_plain()
    release()
    wkv6_head_shards()
    release()
    for phase in (phase_mesh_serving, phase_mesh_moe_serving,
                  phase_mesh_ssm_serving, phase_mesh_audio_vlm_serving,
                  phase_mesh_int8_weights, phase_mesh_paged_moe):
        for name, n in phase().items():
            added[name] = added.get(name, 0) + n
        release()
    for name, n in added.items():
        if name in by_name:      # --only tp times two kernels alone
            by_name[name]["launches"] = by_name[name].get("launches", 0) + n
    log(f"tp-16 and mesh launches added to the records: {added}")


def train_phases():
    """The training phases in order, training on the one-card mesh last;
    returns the launches of the train-then-serve phase by kernel."""
    phase_train_parity()
    release()
    trained = phase_train_paper_gpt()
    release()
    served = phase_train_then_serve(trained)
    del trained
    release()
    phase_train_step_full_width()
    release()
    phase_mesh_train(card_line())
    release()
    return served


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


def ab(roots, paths=False):
    """Times the kernels of several checkouts in turns, on one card: for
    each root, a fresh process builds that checkout's kernels and runs
    this script's kernel phases on them (``--kernels-of``), so every
    checkout is checked and timed by the same code.  Kernel times move
    within 2 % between turns and more between calls, so two versions are
    compared inside one call, in turns (parent, change, change, parent).
    With ``paths`` each turn serves the ``AB_PATHS`` main paths instead
    (``--paths-of``) and the turns compare their host-clock splits (s)."""
    turns = []
    for i, root in enumerate(roots):
        log(f"=== turn {i + 1}: {root}")
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--paths-of" if paths else "--kernels-of",
                               str(Path(root).resolve())],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stdout.write(proc.stderr[-4000:])
        check(proc.returncode == 0, f"the turn in {root} failed "
              f"(exit {proc.returncode})")
        head = '{"paths"' if paths else '{"kernels"'
        lines = [x for x in proc.stdout.splitlines() if x.startswith(head)]
        got = json.loads(lines[-1])
        turns.append({f"{p} {part}": t for p, split in got["paths"].items()
                      for part, t in split.items()} if paths
                     else kernel_times(got["kernels"]))
    log(("s" if paths else "ms") + " per turn ("
        + ", ".join(map(str, roots)) + "):")
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
    ap.add_argument("--paths", action="store_true",
                    help="with --ab: serve the paged and int8-paged main "
                    "paths in each checkout instead, and compare their "
                    "host-clock splits")
    ap.add_argument("--paths-of", metavar="ROOT",
                    help="only build ROOT's kernels and serve the paged and "
                    "int8-paged main paths on them; print their splits")
    ap.add_argument("--only", choices=("train", "tp", "ssm", "audio_vlm",
                                       "mesh_mem", "audit", "long",
                                       "train_mesh"),
                    help="only build the kernels and run these phases "
                    "(no result lines)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is present")
    if args.ab:
        return ab(args.ab, paths=args.paths)
    src = Path(args.kernels_of or args.paths_of or ROOT).resolve() / "src"
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
    if args.paths_of:
        build.build(["decode_attention", "rwkv6", "flash_attention"])
        log(f"serving paths of {build.__file__}")
        for path in AB_PATHS:
            phase_main_path(path)
            release()
        print(json.dumps({"paths": SPLITS}))
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
    if args.only == "train":
        log(f"train-then-serve launches: {train_phases()}")
        return
    if args.only == "train_mesh":
        phase_mesh_train(card)
        log(f"mesh train phase passed; {time.monotonic() - t0:.1f} s from "
            f"the build on")
        return
    if args.only == "ssm":
        wkv6_head_shards()
        release()
        zamba2_shared_block_shards()
        release()
        log(f"mesh ssm launches: {phase_mesh_ssm_serving()}; "
            f"{time.monotonic() - t0:.1f} s from the build on")
        return
    if args.only == "audio_vlm":
        log(f"vlm int8 launches: {phase_vlm_int8_path()}")
        release()
        phase_vlm_int8_stream_pair()
        release()
        log(f"mesh audio and vlm launches: "
            f"{phase_mesh_audio_vlm_serving()}; "
            f"{time.monotonic() - t0:.1f} s from the build on")
        return
    if args.only == "mesh_mem":
        log(f"mesh int8 weight launches: {phase_mesh_int8_weights()}")
        release()
        log(f"mesh paged moe launches: {phase_mesh_paged_moe()}; "
            f"{time.monotonic() - t0:.1f} s from the build on")
        return
    if args.only == "long":
        times, launches = phase_long_decode()
        log(f"long-decode launches: {launches}; kernel times {times}; "
            f"{time.monotonic() - t0:.1f} s from the build on")
        return
    if args.only == "audit":
        phase_audit()
        log(f"audit phase passed; {time.monotonic() - t0:.1f} s from the "
            f"build on")
        return
    if args.only == "tp":
        records = [phase_kernel_vs_plain(), phase_flash_vs_plain()]
        by_name = {r["name"]: r for r in records}
        phase_main_path("dense")      # warms the serving path up
        release()
        tp_phases(by_name)
        log(f"tp phases passed; {time.monotonic() - t0:.1f} s from the "
            f"build on")
        return
    n_hgmma, per_dh = check_flash_sass()
    log(f"flash library SASS: {n_hgmma} HGMMA instructions; per head width "
        f"of the wgmma body {per_dh}")
    # the identity-row wrappers run the resident split body: not part of
    # the kernel phases that --ab times across checkouts (a parent tree
    # before them lacks the wrappers)
    records = kernel_phases() + phase_identity_wrappers_vs_plain()
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
    # the VLM path's launches add to the resident kernel's (dense) and the
    # flash kernel's (glm4) records
    resident = {"dense": by_name["decode_attention_resident"]["launches"]}
    resident["vlm"], flash["vlm"] = phase_vlm_path()
    release()
    # the VLM from an int8 cache: the self layers' launches add to the int8
    # kernel's record, the cross layers' to the resident kernel's
    int8_vlm, resident["vlm int8"], flash["vlm int8"] = phase_vlm_int8_path()
    by_name["decode_attention_int8_resident"]["launches"] += int8_vlm
    log(f"decode_attention_int8_resident launches in its record: + vlm int8 "
        f"{int8_vlm}")
    release()
    # and the zamba2 path's (the shared block's decode and prefill at dh 80)
    resident["zamba2"], flash["zamba2"] = phase_zamba2_path()
    by_name["decode_attention_resident"]["launches"] = \
        sum(resident.values())
    by_name["flash_attention"]["launches"] = \
        flash["glm4"] + flash["vlm"] + flash["vlm int8"] + flash["zamba2"]
    log(f"decode_attention_resident launches in its record: {resident}; "
        f"flash_attention: glm4 {flash['glm4']} + vlm {flash['vlm']} + vlm "
        f"int8 {flash['vlm int8']} + zamba2 {flash['zamba2']}")
    release()
    phase_zamba2_full_depth()
    release()
    # the whole mixtral-8x7b on int8 weights: its ring and flash launches
    # add to those kernels' records
    ring_int8, flash["mixtral int8"] = phase_mixtral_int8_full_depth(card)
    by_name["decode_attention_ring_resident"]["launches"] += ring_int8
    by_name["flash_attention"]["launches"] += flash["mixtral int8"]
    log(f"decode_attention_ring_resident launches in its record: mixtral "
        f"ring + mixtral int8 {ring_int8}; flash_attention: + mixtral int8 "
        f"{flash['mixtral int8']}")
    release()
    cfg4, params4 = mixtral4_params()
    phase_mixtral_capacity(cfg4, params4)
    release()
    phase_mixtral_replicated(cfg4, params4)
    del params4
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
    phase_vlm_stream_pair()
    release()
    phase_vlm_int8_stream_pair()
    release()
    phase_zamba2_stream_pair()
    release()
    phase_int8_weight_stream_pair()
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
    # the hot-path audit of the decode kernels' paths (its launches are
    # the audit's checked steps, logged; each kernel's record keeps its
    # main path's)
    phase_audit()
    release()
    # the tp-16 layout (llama3-8b replicated KV, qwen1.5-32b padded heads)
    # and the one-card mesh: their launches add to the records
    tp_phases(by_name)
    # long-decode under the seq_over_data rules: the bf16 models' launches
    # add to the resident, ring and WKV6 kernels' records
    _, long_launches = phase_long_decode()
    for name, n in long_launches.items():
        by_name[name]["launches"] += n
    log(f"long-decode launches added to the records: {long_launches}")
    release()
    # training on the plain path, then the trained weights served through
    # the flash and resident kernels: their launches add to those records
    served = train_phases()
    for name in ("decode_attention_resident", "flash_attention"):
        by_name[name]["launches"] += served[name]
    log(f"train-then-serve launches added to the records: {served}")
    log(f"every phase passed; {time.monotonic() - t0:.1f} s from the build "
        f"on")
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
