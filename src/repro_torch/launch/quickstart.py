"""Quickstart: build a model from the public API, train a few steps on the
synthetic pipeline, and generate tokens through the KV cache —
counterpart of the JAX package's ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.launch.quickstart            # GPU
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Training runs the model's plain path; ``--use-kernel`` generates through
the flash (prefill) and resident decode kernels, their plain versions on
the CPU.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamW, tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--use-kernel", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else "cpu")

    # 1) config: any --arch id works; reduce it for the demo
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, d_model=128, d_ff=512, n_heads=8, n_kv_heads=4,
        d_head=16, vocab_size=512, dtype="float32", param_dtype="float32")
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    print(f"model: {cfg.name}-reduced, "
          f"{sum(x.numel() for x in tree_leaves(params))/1e3:.0f}K params")

    # 2) a few training steps
    opt = AdamW(lr=1e-3)
    opt_state = opt.init(params)
    train_step = make_train_step(model, opt)
    src = iter(SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=8,
                           seed=0))
    losses = []
    for i in range(10):
        params, opt_state, loss = train_step(
            params, opt_state, to_device(next(src), device))
        losses.append(float(loss))
        if i % 3 == 0:
            print(f"step {i}: loss {losses[-1]:.3f}")

    # 3) autoregressive generation through the cache path
    gen = build_model(cfg, device=device, use_kernel=args.use_kernel)
    prompt = torch.arange(8, dtype=torch.int32, device=device)[None, :]
    state = gen.init_decode_state(params, batch=1, max_seq=32)
    logits, state = make_prefill_step(gen)(params, state, prompt)
    decode = make_decode_step(gen)
    out = []
    tok = logits.argmax(-1)
    for _ in range(12):
        out.append(int(tok[0]))
        logits, state = decode(params, state, tok)
        tok = logits.argmax(-1)
    print("generated:", out)
    return losses, out


if __name__ == "__main__":
    main()
