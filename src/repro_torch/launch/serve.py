"""Serving CLI: batched requests through the port's serving engines with
the paper's interval controller (Algorithm 1 + migrations) in the loop —
counterpart of the JAX package's ``launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \
      --layers 4 --requests 8 --tokens 24 --use-kernel [--straggler 0]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --layers 4 --requests 8 --tokens 24 --use-kernel [--straggler 0]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --layers 4 --max-seq 8192 --prompt-len 4096 --tokens 64 --use-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --layers 4 --slots 8 --requests 16 --prompt-len 1024 --tokens 64 \
      --use-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
      --layers 4 --slots 8 --requests 16 --prompt-len 8192 \
      --mixed-lengths --tokens 64 --use-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --layers 4 --slots 8 --requests 16 --tokens 64 --use-kernel \
      --pipeline-k 2 --search bottleneck --straggler 0
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-11b --layers 10 --slots 8 --requests 16 \
      --prompt-len 512 --mixed-lengths --tokens 64 --img-tokens 1601 \
      --use-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --layers 12 --slots 8 --requests 16 --prompt-len 1024 --tokens 64 \
      --use-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-32b \
      --layers 4 --slots 8 --requests 16 --tokens 64 --use-kernel --tp 16

The default ``--arch`` is musicgen-large, as in the reference.  Runs on
the GPU unless ``--device cpu`` is given (``--reduced`` shrinks the widths
to a CPU-sized model, keeping MHA where the arch has it, and a sliding
window to 16 tokens).
``--engine auto`` picks the continuous engine where the arch and the
served extent allow it and the wave engine otherwise (a sliding-window
arch whose ``--max-seq``, default prompt + tokens + 8, reaches its window
keeps a ring cache; the attention-free rwkv6-7b always takes the wave
engine).  ``--paged [--page-size P]`` serves from a paged KV
cache and ``--kv-quant`` from an int8 one, alone or together (continuous
engine).  ``--pipeline-k K`` keeps K decode tokens in flight across slot
groups (K divides ``--slots``) and ``--search bottleneck`` plans the
migrations with the bottleneck-targeted search (with K > 1).  The VLM
(llama-3.2-vision-11b; ``--layers`` a multiple of 5) holds an image buffer
of ``--img-tokens`` rows a slot, and its requests carry seeded images of
all, half and none of those rows, in turn.  The Zamba2 hybrid
(zamba2-2.7b; ``--layers`` a multiple of its supergroup of 6, or of 2 with
``--reduced``, which keeps the reference's 4 layers with a shared block
every 2) always takes the wave engine, and its head plans are logged as not
applied.  ``--tp N`` builds the model in the tensor-parallel head layout
of degree N (query heads zero-padded to a multiple of N; KV heads
replicated up to N where there are fewer), which the controller places
over max(N, 4) simulated devices.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.baselines import ResourceAwarePolicy
from repro_torch.serving.engine import make_engine

# the sliding window of a reduced config, so a short CPU run wraps its ring
REDUCED_WINDOW = 16


def reduced_for_cpu(cfg, d_model: int = 256):
    """CPU-sized widths (the reference's ``launch.train.reduced_for_cpu``:
    4 experts for MoE; a hybrid keeps 4 layers with a shared block every
    2), plus a ``REDUCED_WINDOW``-token sliding window for windowed
    archs."""
    over = dict(d_model=d_model, d_ff=d_model * 4, vocab_size=4096,
                n_heads=8, n_kv_heads=min(8, cfg.n_kv_heads or 8),
                d_head=d_model // 8, dtype="float32", param_dtype="float32")
    if cfg.family == "hybrid":
        over.update(n_layers=4, shared_attn_every=2)
    if cfg.is_moe:
        over["n_experts"] = 4
    if cfg.sliding_window:
        over["sliding_window"] = REDUCED_WINDOW
    return cfg.with_overrides(**over)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized widths (d_model 256, 8 heads, f32)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (widths unchanged)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--lam", type=int, default=8,
                    help="controller interval (decode steps)")
    ap.add_argument("--straggler", type=int, default=-1,
                    help="inject a 20x slowdown on this simulated device")
    ap.add_argument("--mixed-lengths", action="store_true",
                    help="vary prompt lengths per request")
    ap.add_argument("--use-kernel", action="store_true",
                    help="decode through the placement-driven flash-decode "
                         "kernel and prefill through the flash attention "
                         "kernel (rwkv6-7b: prefill and decode through the "
                         "WKV6 kernel; plain versions on the CPU); greedy "
                         "streams must match the plain path")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache with per-(token, head) scales")
    ap.add_argument("--pipeline-k", type=int, default=1,
                    help="decode tokens in flight across slot groups "
                         "(must divide --slots)")
    ap.add_argument("--search", default="rescoring",
                    choices=ResourceAwarePolicy.SEARCH_MODES,
                    help="controller placement search: rescoring "
                         "(Algorithm 1, refine, filter) or the "
                         "bottleneck-targeted search (pipeline-k > 1)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: pooled page store + per-slot "
                         "page tables, chunked prefill; streams must match "
                         "the dense engine at the same seed")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page (--paged)")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "continuous", "wave"),
                    help="continuous batching (where the arch and extent "
                         "allow it) or the wave scheduler")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="served extent (default prompt + tokens + 8); a "
                         "sliding-window arch keeps a ring at or past its "
                         "window")
    ap.add_argument("--img-tokens", type=int, default=16,
                    help="VLM: image rows a slot holds (requests carry "
                         "images of all, half and none of them, in turn)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree of the head layout")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_for_cpu(cfg)
    if args.layers:
        cfg = cfg.with_overrides(n_layers=args.layers)
    if args.kv_quant:
        cfg = cfg.with_overrides(kv_quant=True)
    kw = {}
    vlm = cfg.family == "vlm"
    if vlm:
        kw["img_tokens"] = args.img_tokens
    mode = args.engine
    max_seq = args.max_seq or args.prompt_len + args.tokens + 8
    if args.paged:
        # pages divide max_seq; the paged cache is the continuous engine's
        kw.update(paged=True, page_size=args.page_size)
        max_seq += -max_seq % args.page_size
        mode = "continuous"
    eng = make_engine(cfg, mode=mode, n_slots=args.slots, max_seq=max_seq,
                      lam=args.lam, use_kernel=args.use_kernel,
                      pipeline_k=args.pipeline_k, search=args.search,
                      device=args.device, tp=args.tp, **kw)
    print(f"[serve] {cfg.name} engine: {type(eng).__name__} on {eng.device}, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, max_seq {max_seq}"
          f"{f', window {cfg.sliding_window}' if cfg.sliding_window else ''}")
    hd = getattr(eng.model, "hd", None)
    if hd is not None and args.tp > 1:
        print(f"[serve] tp {args.tp}: Hp {hd.Hp}, Kp {hd.Kp}, rep {hd.rep}, "
              f"KvE {hd.KvE} over {eng.net.n_devices} devices")
    if args.straggler >= 0:
        eng.net.inject_straggler(args.straggler, slowdown=20.0)
        print(f"[serve] injected straggler on device {args.straggler}")
    rng = np.random.default_rng(0)
    img_rows = (args.img_tokens, max(1, args.img_tokens // 2), 0)
    t0 = time.time()
    for i in range(args.requests):
        if args.mixed_lengths:
            plen = int(rng.integers(max(2, args.prompt_len // 2),
                                    args.prompt_len + 1))
        else:
            plen = args.prompt_len
        img = None
        if vlm and img_rows[i % 3]:
            img = rng.standard_normal((img_rows[i % 3], cfg.d_model),
                                      np.float32)
        eng.submit(rng.integers(0, cfg.vocab_size, size=plen),
                   max_new_tokens=args.tokens,
                   **({"img_embeds": img} if vlm else {}))
    done = eng.run()
    wall = time.time() - t0
    total_toks = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {total_toks} tokens in "
          f"{wall:.1f}s ({total_toks / wall:.1f} tok/s)")
    migr = sum(m["n_migrations"] for m in eng.migration_log)
    emigr = sum(m["n_expert_migrations"] for m in eng.migration_log)
    print(f"[serve] controller intervals={len(eng.migration_log)} "
          f"head-migrations={migr} expert-migrations={emigr}")
    if hasattr(eng, "slot_busy_steps") and eng.decode_steps:
        util = eng.slot_busy_steps / (eng.decode_steps * eng.n_slots)
        print(f"[serve] slot utilization {util:.0%}, prefill buckets "
              f"{sorted(eng.prefill_buckets_used)}")
    for r in done[:3]:
        print(f"  req {r.rid}: ttft={r.t_first - r.t_submit:.2f}s "
              f"total={r.t_done - r.t_submit:.2f}s "
              f"tokens={r.out_tokens[:8]}...")
    return done


if __name__ == "__main__":
    main()
