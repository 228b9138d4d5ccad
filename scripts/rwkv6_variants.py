#!/usr/bin/env python3
"""Check or time patched copies of the WKV6 kernel on one GPU.

    python3 scripts/rwkv6_variants.py base skip_inter no_floor no_bonus
    python3 scripts/rwkv6_variants.py base tf32_1pass no_compensation base

For each named variant, in the order given, copies ``src/`` into a
temporary directory, applies the variant's edits to the copy's
``csrc/rwkv6.cu`` (``base``: none), and in a fresh process on the copy's
kernel runs ``chip_smoke.py``'s WKV6 checks (``rwkv6_cases``: both bodies
at the rwkv6 path's widths, f32 and bf16, smooth and extreme decays,
chained in-place calls) and then its times (``rwkv6_times``, without the
plain version's), also for a variant that fails its checks.  Prints the
copy's ptxas lines for the WKV6 kernel, every check and time line, the
cases that failed, and last the times and worst error per turn (the
machinery is ``decode_split_variants.run_turns``).

Faults (each must fail every case it affects): ``skip_inter`` (the middle
chunk of a call skips the inter-chunk term), ``no_floor`` (no floor under
log2 w: a w of 0 gives -inf - -inf = NaN), ``no_bonus`` (the bonus, A's
diagonal, is dropped).  The per-step body (S < 16) is unaffected by all
three.

Variants: ``tf32_1pass`` (each product one TF32 pass, hi * hi),
``split_rna`` (an operand's hi part rounded to nearest TF32 with
``cvt.rna``, four instructions, where the source truncates it with one),
``no_compensation`` (plain float32 prefix and suffix sums of log2 w, lo =
0), ``log2_accurate`` (``log2f`` for ``__log2f``, the MUFU
approximation), ``lb3`` (a cap of 3 blocks an SM, so up to 168
registers), ``y_on_use`` (y's (b, h) base formed at each chunk's store
instead of once), ``carveout_max`` (asks for the largest shared-memory
carveout), ``t_occupancy`` (prints the blocks an SM the runtime allows the
chunked body).

Timing only, with wrong results: ``t_no_pairs`` (no parts of A's pairs
s < t), ``t_no_channel`` (no per-channel pass: no sums, decays or f32
rows), ``t_no_mma`` (each mma.sync replaced by one integer op on its
operands, so the products' loads and splits stay but the tensor cores
idle), ``t_clock`` (block 0 sums ``clock64`` cycles per phase and warp
and writes them over its first y row; the turn prints them).
"""
from __future__ import annotations

import sys
from pathlib import Path

from decode_split_variants import run_turns

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("repro_torch/kernels/csrc/rwkv6.cu")
INTER = "    auto inter = [&](int kk) {\n"
MMA3 = """  if (!exact_a) mma_tf32(d, a.lo, b.hi);
  if (!exact_b) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);"""
MMA_ASM = """  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));"""
# t_clock: cycles of each phase, summed over the chunks, per warp
CLK = "    {{ const long long c = clock64(); ph[{}] += c - tp; tp = c; }}\n"
VARIANTS = {
    "base": [],
    "skip_inter": [(INTER, INTER + "      if (ch == n_chunks / 2) return;\n")],
    "no_floor": [("        lm = lm < kLog2Floor ? kLog2Floor : lm;"
                  "  // (a NaN stays NaN)\n", ""),
                 ("(wv < kFloorW ? kFloorW : wv)", "wv")],
    "no_bonus": [("sh.part[s * (s + 3) / 2][cg] = part;",
                  "sh.part[s * (s + 3) / 2][cg] = 0.f;")],
    "tf32_1pass": [(MMA3, "  mma_tf32(d, a.hi, b.hi);")],
    "no_compensation": [("  lo += (hi - (s - bb)) + (l - bb);\n", "")],
    "lb3": [("__launch_bounds__(2 * DH, 4)", "__launch_bounds__(2 * DH, 3)")],
    "log2_accurate": [("__log2f(wv)", "log2f(wv)")],
    "split_rna": [("  hi = __float_as_uint(x) & 0xffffe000u;",
                   '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));')],
    # timing only (wrong results): a part of the chunked body left out
    "t_no_pairs": [("        sh.part[e][cg] = part;\n", "")],
    "t_no_channel": [("    {\n      const int i = tid >> 1, role = tid & 1;",
                      "    if (n < 0) {\n      const int i = tid >> 1, "
                      "role = tid & 1;")],
    "t_clock": [
        ("  stage(0, 0);\n", "  long long tp = clock64(), ph[5] = {};\n"
         "  stage(0, 0);\n"),
        ("    cp_async_wait_all();\n",
         CLK.format(0) + "    cp_async_wait_all();\n"),
        ("    __syncthreads();  // chunk ch staged; the last chunk's reads "
         "are done\n", "    __syncthreads();\n" + CLK.format(1)),
        ("    __syncthreads();  // the chunk's f32 rows are written\n",
         "    __syncthreads();\n" + CLK.format(2)),
        ("    __syncthreads();  // the parts of A are written\n",
         "    __syncthreads();\n" + CLK.format(3)),
        ("    __syncthreads();  // A is written\n",
         "    __syncthreads();\n" + CLK.format(4)),
        ("\n  float* sT = a.sT + b * a.sT_sb + h * a.sT_sh + j0 + g;\n",
         "\n  __syncthreads();\n  if (blockIdx.x == 0 && lane == 0)\n"
         "    for (int e = 0; e < 5; ++e)\n"
         "      y[5 * (tid >> 5) + e] = static_cast<float>(ph[e]);\n"
         "  float* sT = a.sT + b * a.sT_sb + h * a.sT_sh + j0 + g;\n")],
    "t_occupancy": [
        ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
        ("  if (set != cudaSuccess) return static_cast<int>(set);\n"
         "  rwkv6_chunk_kernel",
         "  if (set != cudaSuccess) return static_cast<int>(set);\n"
         "  static const int occ = [] {\n    int n = 0;\n"
         "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
         "        &n, rwkv6_chunk_kernel<T, U, DH>, 2 * DH, bytes);\n"
         "    printf(\"OCCUPANCY dh %d: %d blocks an SM, %d bytes\\n\", DH, n,"
         " bytes);\n    return n;\n  }();\n  (void)occ;\n"
         "  rwkv6_chunk_kernel")],
    "carveout_max": [
        ("  if (set != cudaSuccess) return static_cast<int>(set);\n"
         "  rwkv6_chunk_kernel",
         "  if (set != cudaSuccess) return static_cast<int>(set);\n"
         "  static const cudaError_t co = cudaFuncSetAttribute(\n"
         "      rwkv6_chunk_kernel<T, U, DH>,\n"
         "      cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
         "  if (co != cudaSuccess) return static_cast<int>(co);\n"
         "  rwkv6_chunk_kernel")],
    "y_on_use": [("  float* y = a.y + b * a.y_sb + h * a.y_sh;\n\n", "\n"),
                 ("#pragma unroll\n    for (int nn = 0; nn < 2; ++nn) {\n"
                  "      float* yo",
                  "    float* y = a.y + b * a.y_sb + h * a.y_sh;\n"
                  "#pragma unroll\n    for (int nn = 0; nn < 2; ++nn) {\n"
                  "      float* yo")],
    "t_no_mma": [(MMA_ASM, "  d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] "
                           "^ a[3] ^ b[0] ^ b[1]);")],
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
for text in build.build(["rwkv6"]).values():
    for variant, usage in c.ptxas_usage(text):
        c.log(f"  ptxas: {{variant}}: {{usage}}")
worst, bad = c.rwkv6_cases()
if bad:
    print(f"CASES FAILED ({{len(bad)}}): {{bad}}", flush=True)
times = {{label: t["ms"] for label, t in c.rwkv6_times(False).items()}}
times["max_abs_err"] = worst
if {clock!r}:
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    args = c.rwkv6_inputs(torch.bfloat16, S=c.RWKV_PROMPT)
    for _ in range(2):
        y, _ = rwkv6_chunked(*args)
    torch.cuda.synchronize()
    cyc = y[0, 0, 0, :20].view(4, 5).tolist()
    c.log("cycles of block 0 per warp (wait + top sync, channel pass, pairs"
          " + inter-chunk product, sum pass, intra + state): " + str(cyc))
print("TIMES " + json.dumps(times), flush=True)
"""


def main(names):
    run_turns(names, VARIANTS, SOURCE, lambda name, src: TURN.format(
        src=str(src), root=str(ROOT), clock=name == "t_clock"))


if __name__ == "__main__":
    main(sys.argv[1:])
