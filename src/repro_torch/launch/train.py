"""Training launcher: synthetic data pipeline -> train step -> checkpointing
-> resume — counterpart of the JAX package's ``launch/train.py``, with its
twelve flags, log lines and checkpoint tree (``{"params", "opt",
"data"}``), plus ``--device``.  It trains on one device through the
model's plain path (the kernels have no backward).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt \\
      [--resume] [--device cpu]

Without ``--device cpu`` it wants the GPU and raises where none is
present, as ``device.resolve_device`` does.  When the last step falls
on a checkpoint interval the asynchronous save already wrote it, so the
final save is not repeated (the reference writes the same tree twice).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule, tree_leaves
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor


def reduced_for_cpu(cfg, d_model=256, n_layers=4):
    over = dict(n_layers=n_layers, d_model=d_model,
                d_ff=d_model * 4, vocab_size=4096,
                dtype="float32", param_dtype="float32")
    if cfg.n_heads:
        over.update(n_heads=8, n_kv_heads=min(8, cfg.n_kv_heads or 8),
                    d_head=d_model // 8)
    if cfg.family == "vlm":
        over["n_layers"] = 5
    if cfg.family == "hybrid":
        over.update(n_layers=4, shared_attn_every=2)
    if cfg.is_moe:
        over["n_experts"] = 4
    return cfg.with_overrides(**over)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-gpt")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None, record=None):
    """Train as the flags say and return the final loss.  ``record``, a
    list, receives one dict per step ({"step", "loss", "seconds"}) and
    then the checkpointer's save and restore records."""
    args = parser().parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else "cpu")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_for_cpu(cfg, args.d_model, args.n_layers)
    model = build_model(cfg, device=device)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=20, total=args.steps))
    step_fn = make_train_step(model, opt)

    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    it = iter(src)
    ck = Checkpointer(args.ckpt)
    monitor = HeartbeatMonitor(
        torch.cuda.device_count() if device.type == "cuda" else 1)

    start = 0
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_state = opt.init(params)
    if args.resume and ck.latest_step() is not None:
        start = ck.latest_step()
        state = ck.restore(start, {"params": params, "opt": opt_state,
                                   "data": src.state_dict()})
        params, opt_state = state["params"], state["opt"]
        src.load_state_dict(state["data"])
        it = iter(src)
        print(f"[train] resumed from step {start}")

    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq}")
    loss = float("nan")
    try:
        for i in range(start, args.steps):
            batch = to_device(next(it), device)
            t0 = time.time()
            params, opt_state, loss = step_fn(params, opt_state, batch)
            # the per-step sync is the point: dt below must cover the
            # device step for monitor.record_step telemetry
            loss = float(loss)
            dt = time.time() - t0
            monitor.record_step(0, dt)
            if record is not None:
                record.append({"step": i + 1, "loss": loss, "seconds": dt})
            if (i + 1) % args.log_every == 0 or i == start:
                tps = args.batch * args.seq / dt
                print(f"[train] step {i+1:5d} loss={loss:.4f} "
                      f"{dt*1e3:7.1f} ms/step {tps:9.0f} tok/s")
            if (i + 1) % args.ckpt_every == 0:
                ck.save_async(i + 1, {"params": params, "opt": opt_state,
                                      "data": src.state_dict()})
    finally:
        # a fault still lets the checkpoint in flight commit, so a
        # restart resumes from it
        ck.wait()
    if not (args.steps > start and args.steps % args.ckpt_every == 0):
        ck.save(args.steps, {"params": params, "opt": opt_state,
                             "data": src.state_dict()})
    if record is not None:
        record.extend(ck.log)
    print(f"[train] done; final loss={loss:.4f}; "
          f"checkpoints at {args.ckpt}")
    return loss


if __name__ == "__main__":
    main()
