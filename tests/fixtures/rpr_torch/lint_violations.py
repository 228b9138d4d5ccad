"""Seeded RPR violations of torch code — the port's lint self-test corpus.

Never linted by a directory scan (``fixtures`` is in
``repro_torch.analysis.lints.EXCLUDED_PARTS``, and in the reference
linter's); ``tests/test_torch_analysis.py`` lints this file explicitly
and asserts that every rule fires exactly on the lines marked
``# expect: CODE``.  Each function is one violation class, deliberately
wrong.
"""
import torch


def reseeded_in_loop(n):
    outs = []
    for _ in range(n):
        gen = torch.Generator().manual_seed(0)  # expect: RPR001
        outs.append(torch.randn(4, generator=gen))
    return outs


class Sampler:
    def counter_seed(self):
        return torch.manual_seed(self.decode_steps)  # expect: RPR001


def swallow(fn):
    try:
        fn()
    except Exception:  # expect: RPR003
        return None


def swallow_bound_unused(fn):
    try:
        fn()
    except Exception as e:  # expect: RPR003
        return None


def decode_loop(model, params, state, tok):
    seen = []
    for _ in range(8):
        logits, state = model.decode_step(params, state, tok)
        seen.append(logits.max().item())  # expect: RPR004
        seen.append(logits.argmax(-1).tolist())  # expect: RPR004
        tok = logits.argmax(-1).cpu()  # expect: RPR004
    return seen, tok


def waived_without_reason(fn):
    try:
        fn()
    except Exception:  # rpr: ignore[RPR003]  # expect: RPR000
        return None


def properly_waived(fn):
    try:
        fn()
    # rpr: ignore[RPR003] -- fixture: a reasoned waiver must suppress
    except Exception:
        return None


def host_reads_outside_the_hot_path(xs):
    # no hot-path call here: host reads in a loop are fine
    return [x.item() for x in xs] + [float(x) for x in xs]
