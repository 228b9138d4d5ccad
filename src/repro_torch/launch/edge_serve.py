"""End-to-end serving demo (the paper's kind = inference): continuous
batching with the resource-aware controller migrating attention heads away
from an injected straggler, live — with mixed prompt lengths in one batch
and freed slots re-admitted mid-stream.  Counterpart of the JAX package's
``examples/edge_serve.py``: the same reduced musicgen-large (MHA, so every
head migrates on its own), the same two phases and the same 25x straggler,
with decode and prefill attention through the port's kernels (their plain
versions on the CPU).

  PYTHONPATH=src python -m repro_torch.launch.edge_serve            # GPU
  PYTHONPATH=src python -m repro_torch.launch.edge_serve --device cpu

The controller prices placements at the production widths of the full
musicgen-large (``cost_cfg``) over the per-layer block graph of the
served model's 3 layers: one head permutation per layer.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serving.engine import ServingEngine


def reduced_musicgen():
    """musicgen-large at CPU widths: 3 layers, d_model 128, 8 heads of 16
    over 8 KV heads, d_ff 512, vocab 512, float32."""
    return get_config("musicgen-large").with_overrides(
        n_layers=3, d_model=128, d_ff=512, n_heads=8, n_kv_heads=8,
        d_head=16, vocab_size=512, dtype="float32", param_dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    cfg = reduced_musicgen()
    engine = ServingEngine(cfg, n_slots=4, max_seq=96, lam=6,
                           cost_cfg=get_config("musicgen-large"),
                           use_kernel=True, device=args.device)
    print(f"engine: {engine.net.n_devices} slots on {engine.device}, "
          f"{cfg.n_heads} heads, controller interval λ={engine.lam}, "
          f"prefill buckets {engine.buckets}")

    rng = np.random.default_rng(0)
    # phase 1: healthy cluster — mixed prompt lengths share one batch while
    # the controller settles a placement
    for i, n in enumerate((6, 12, 9, 17)):
        engine.submit(rng.integers(0, cfg.vocab_size, size=n),
                      max_new_tokens=18 + 4 * (i % 2))
    engine.run()
    counts = engine.controller.head_counts()   # heads/device, all layers
    busiest = int(counts.argmax())
    before = int(counts[busiest])

    # phase 2: the busiest device becomes a 25x straggler mid-service;
    # Algorithm 1 must migrate heads away, permuting a KV cache whose slots
    # sit at different sequence positions
    engine.net.inject_straggler(busiest, slowdown=25.0)
    print(f"injected 25x straggler on slot {busiest} "
          f"(holding {before} heads)")
    for n in (8, 15, 11, 20):
        engine.submit(rng.integers(0, cfg.vocab_size, size=n),
                      max_new_tokens=24)
    done = engine.run()

    print(f"\nserved {len(done)} requests, {engine.decode_steps} decode steps")
    util = engine.slot_busy_steps / max(engine.decode_steps * engine.n_slots,
                                        1)
    print(f"slot utilization {util:.0%}, prefill buckets "
          f"{sorted(engine.prefill_buckets_used)}")
    migrated = sum(m["n_migrations"] for m in engine.migration_log)
    print(f"controller ran {len(engine.migration_log)} intervals, "
          f"migrated {migrated} head-blocks")
    after = int(engine.controller.head_counts()[busiest])
    print(f"heads on straggler slot {busiest}: {before} -> {after}")
    for r in done[:4]:
        print(f"  req {r.rid}: {len(r.out_tokens)} tokens, "
              f"latency {r.t_done - r.t_submit:.2f}s")
    return engine


if __name__ == "__main__":
    main()
