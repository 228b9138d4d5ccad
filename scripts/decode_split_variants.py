#!/usr/bin/env python3
"""Check or time patched copies of the split decode body on one GPU.

    python3 scripts/decode_split_variants.py base skip_split zero_piece
    python3 scripts/decode_split_variants.py base mma_lb4 cuda_core base

For each named variant, in the order given, copies ``src/`` into a
temporary directory, applies the variant's edits to the copy's
``csrc/decode_attention.cu`` (``base``: none), and runs ``chip_smoke.py``'s
two split-body phases — ``phase_kernel_vs_plain`` (the resident kernel at
the dense and glm4 shapes) and ``phase_new_kernels_vs_plain`` (the int8,
paged and int8-paged kernels) — on the copy's kernels in a fresh process,
so every split entry point is checked in every turn.  A phase that fails
(a planted fault) is reported after it has logged every case, and then
records no times.  Prints the copy's ptxas lines for the split body, every
check and time line, and last the times per turn.

Faults (each must fail every case of both phases): ``skip_split`` (the
merge drops split n / 2), ``zero_piece`` (the last 16-byte piece of each
staged K row zero-filled), ``unstaged_piece`` (that piece never staged).
Tuning variants: ``mma_lb4`` / ``core_lb4`` (a cap of 4 blocks an SM for
the tensor-core / CUDA-core body), ``mma_st4`` / ``core_st4`` (a fourth
stage), ``cuda_core`` (bf16 q on the CUDA-core body, over any K/V),
``paged_per_piece`` (a paged stage divides by the page size for every row
a thread copies, not once a tile), ``stage_unroll1`` /
``stage_unrolled`` (the staging loop unrolled for no source / for every
source; the source unrolls it for paged ones only), ``per_piece_stage``
(every source's stage finds each 16-byte piece's row from a flat piece
index and locates it on its own, as PR 17's did).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("repro_torch/kernels/csrc/decode_attention.cu")
STAGE_K = ("    cp_async16(kt + c * ROW + d, kb + blk * src.k_sb + o * "
           "src.k_st + d, in);")
STEP = """    if (Src::kPaged && i > 0) {
      off += RS;
      while (off >= src.T_len) {
        off -= src.T_len;
        ++lp;
      }
    }"""
STAGE_UNROLL = "#pragma unroll (Src::kPaged ? TS : 1)\n"
STAGE_ROWS = """  const int c0 = tid / CH, d = (tid % CH) * VE;
  int lp = 0, off = 0;  // PAGED: the logical page and offset of row c
  if (Src::kPaged) {
    lp = (t0 + c0) / src.T_len;
    off = t0 + c0 - lp * src.T_len;
  }
#pragma unroll (Src::kPaged ? TS : 1)
  for (int i = 0; i < (TS + RS - 1) / RS; ++i) {
    const int c = c0 + i * RS;
    if (c >= TS) break;  // RS > TS: this thread has no row
""" + STEP + """
    const bool in = t0 + c < t_end;
    const int64_t blk = Src::kPaged && in ? pages[lp - first_pg] : 0;
    const int o = !in ? 0 : Src::kPaged ? off : t0 + c;
"""
PER_PIECE = """#pragma unroll
  for (int e = tid; e < TS * CH; e += kRingThreads) {
    const int c = e / CH, d = (e % CH) * VE, t = t0 + c;
    const bool in = t < t_end;
    int64_t blk = 0;
    int o = 0;
    if (in) src.locate(pages, first_pg, t, blk, o);
"""
VARIANTS = {
    "base": [],
    "skip_split": [(
        "  float m_all = kNegInf;\n  for (int s = 0; s < n; ++s) m_all",
        "  if (PREFIX && n > 1) {\n    ml[2 * (n / 2)] = kNegInf;\n"
        "    ml[2 * (n / 2) + 1] = 0.f;\n  }\n"
        "  float m_all = kNegInf;\n  for (int s = 0; s < n; ++s) m_all")],
    "zero_piece": [(STAGE_K, STAGE_K.replace(
        "in);", "in && d != DH - VE);"))],
    "unstaged_piece": [(STAGE_K, "    if (d != DH - VE)\n  " + STAGE_K)],
    "mma_lb4": [("__launch_bounds__(kRingThreads, 3)\n"
                 "decode_split_mma_kernel",
                 "__launch_bounds__(kRingThreads, 4)\n"
                 "decode_split_mma_kernel")],
    "core_lb4": [("__launch_bounds__(kRingThreads, 3)\ndecode_split_kernel",
                  "__launch_bounds__(kRingThreads, 4)\ndecode_split_kernel")],
    "mma_st4": [("constexpr int kMmaStages = 3;",
                 "constexpr int kMmaStages = 4;")],
    "core_st4": [("constexpr int kSplitStages = 3;",
                  "constexpr int kSplitStages = 4;")],
    "cuda_core": [("constexpr bool kMma = std::is_same",
                   "constexpr bool kMma = false && std::is_same")],
    "paged_per_piece": [(STEP, """    if (Src::kPaged) {
      lp = (t0 + c) / src.T_len;
      off = t0 + c - lp * src.T_len;
    }""")],
    "stage_unroll1": [(STAGE_UNROLL, "#pragma unroll 1\n")],
    "stage_unrolled": [(STAGE_UNROLL, "#pragma unroll\n")],
    "per_piece_stage": [(STAGE_ROWS, PER_PIECE)],
}

# run in a fresh process per variant, with the copy's src first on the path
TURN = """
import json, sys
sys.path.insert(0, {src!r})
sys.path.insert(1, {root!r})
import torch
import chip_smoke as c
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
for text in build.build(["decode_attention"]).values():
    for variant, usage in c.ptxas_usage(text):
        if variant.startswith("split"):
            c.log(f"  ptxas: {{variant}}: {{usage}}")
times = {{}}
try:
    r = c.phase_kernel_vs_plain()
    for label, t in r["shapes"].items():
        times[f"resident [{{label}}]"] = t["ms"]
        times[f"resident [{{label}}] sdpa"] = t["library_ms"]
    times["resident max_rel_err"] = r["max_rel_err"]
except c.SmokeFailure as e:
    print(f"PHASE FAILED phase_kernel_vs_plain: {{e}}", flush=True)
try:
    for rec in c.phase_new_kernels_vs_plain():
        times[rec["name"]] = rec["ms"]
        if "max_rel_err" in rec:
            times[rec["name"] + " max_rel_err"] = rec["max_rel_err"]
except c.SmokeFailure as e:
    print(f"PHASE FAILED phase_new_kernels_vs_plain: {{e}}", flush=True)
print("TIMES " + json.dumps(times), flush=True)
"""


def patched_copy(name: str, edits, source: Path, into: Path) -> Path:
    """A copy of ``src/`` under ``into`` with ``edits`` (old, new) applied
    to ``source``; each old text must occur exactly once."""
    src = into / name / "src"
    shutil.copytree(ROOT / "src", src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    text = (src / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: its edit does not apply")
        text = text.replace(old, new)
    (src / source).write_text(text)
    return src


def run_turns(names, variants, source: Path, turn):
    """For each named variant, in order, a patched copy of ``src/`` and a
    fresh process running ``turn(name, copy's src)``; prints its output
    but the ``TIMES {json}`` line, then every key of those lines per
    turn."""
    unknown = [n for n in names if n not in variants]
    if not names or unknown:
        raise SystemExit(f"name variants from {sorted(variants)}; unknown: "
                         f"{unknown}")
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(names):
            src = patched_copy(name, variants[name], source,
                               Path(tmp) / str(i))
            print(f"=== turn {i + 1}: {name}", flush=True)
            proc = subprocess.run([sys.executable, "-c", turn(name, src)],
                                  capture_output=True, text=True)
            lines = proc.stdout.splitlines()
            print("\n".join(x for x in lines if not x.startswith("TIMES ")),
                  flush=True)
            if proc.returncode:
                print(proc.stderr[-3000:], flush=True)
            found = [x for x in lines if x.startswith("TIMES ")]
            turns.append(json.loads(found[-1][6:]) if found else {})
    print("=== per turn (" + ", ".join(names) + ")")
    for key in sorted({k for t in turns for k in t}):
        print(f"{key}: " + " / ".join(
            f"{t[key]:.4g}" if key in t else "-" for t in turns))


def main(names):
    run_turns(names, VARIANTS, SOURCE,
              lambda name, src: TURN.format(src=str(src), root=str(ROOT)))


if __name__ == "__main__":
    main(sys.argv[1:])
