#!/usr/bin/env python3
"""Cycles per tile in each phase of kernel A, for one or more checkouts,
on one CUDA card.

    python3 phase_clocks.py TREE [TREE ...]

Kernel A (``csrc/fused_whiten.cu``) walks 32-sample tiles in three phases
separated by barriers: the build of Kuf's tile, A = tril(Linv) Kuf, and U
+= A A^T.  For each TREE (a checkout holding ``chip_smoke.py`` and
``gpitch_tpu_torch``), this copies the package into
``build/phase_clocks/<n>/``, inserts ``clock64()`` counters into kernel A at
the comments that open the A and U phases (``// ---- A = tril(Linv) Kuf``,
``// ---- U += A A^T, lower blocks``; a tree without them is refused),
builds the copy, runs kernel A at the SoSp width (222 windows, M 112, 3 x
5) and the AMT width (43 windows, M 160, 8 x 10), one block per window,
and prints, per width, the median over windows of the cycles per tile that
warps 0 and 4 spent from a tile's start to the A phase (the build and its
barriers), then to the U phase (A, its store and their barriers), then to
the tile's end.  The
counters overwrite U[w, 0, :6]; nothing is checked.  A block shares its SM
with another at M 112 (two resident blocks), so the cycles there are those
of two blocks interleaved.

    python3 phase_clocks.py --bwd TREE [TREE ...]

does the same for kernel B, whose tiles take six phases: the build of
Kuf's tile (``// ---- the build``), A = tril(Linv) Kuf (``// ---- A =
tril(Linv) Kuf``), dA = G A + dv err^T (``// ---- dA = G A``), dLinv +=
dA Kuf^T (``// ---- dLinv += dA Kuf^T``), dK = tril(Linv)^T dA (``// ----
dK = tril(Linv)^T dA``) and the per-source sums (``// ---- per-source
sums``): the cycles per tile of warps 0 and 2 from each comment to the
next (the first from the tile's start, the last to its end); the counters
overwrite dLinv[w, 0, :12].  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# (anchor in kernel A, text inserted before it)
_PATCHES = [
    ("  for (int tn = begin; tn < end; ++tn) {\n",
     "  long long tb = 0, ta = 0, tu = 0, c0 = 0, c1;\n"),
    ("    // ---- A = tril(Linv) Kuf", "    c1 = clock64(); tb += c1 - c0; c0 = c1;\n"),
    ("    // ---- U += A A^T, lower blocks", "    c1 = clock64(); ta += c1 - c0; c0 = c1;\n"),
    ("  float* rec = a.part + (static_cast<int64_t>(w) * a.splits + blockIdx.x) * a.rec;\n",
     "  tu += clock64() - c0;\n"),
]
_LOOP_TOP = ("  for (int tn = begin; tn < end; ++tn) {\n",
             "    { const long long now = clock64(); if (tn > begin) tu += now - c0; "
             "c0 = now; }\n")
_KERNEL_END = ("  __syncthreads();\n  if (threadIdx.x == 0 || threadIdx.x == 128) {\n"
               "    const int o = threadIdx.x == 0 ? 0 : 3;\n"
               "    rec[o] = (float)tb; rec[o + 1] = (float)ta; rec[o + 2] = (float)tu;\n  }\n")

_CHILD = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import importlib
import chip_smoke as cs
fw = importlib.import_module("gpitch_tpu_torch.linalg.fused_whiten")
dev = torch.device("cuda")
amt_f0 = 261.6 * 2 ** (np.arange(8) / 12)
sosp_f0 = 261.6 * 2 ** (np.array([0, 4, 7]) / 12)
cases = {"a_sosp": cs._whiten_inputs(222, 2001, 112, cs._harmonics(sosp_f0, 5, 16000.0),
                                     16000.0),
         "b_amt": cs._whiten_inputs(43, 2001, 160, cs._harmonics(amt_f0, 10, 44100.0),
                                    44100.0)}
names = ("zc", "xc", "err", "linv", "energy", "freq", "var", "inv_l")
out = {}
for k, d in cases.items():
    args = [torch.as_tensor(np.array(d[n]), dtype=torch.float32, device=dev) for n in names]
    for _ in range(2):
        u, _v = fw._forward_kernel(*args, splits=1)
    torch.cuda.synchronize()
    tiles = -(-args[1].shape[-1] // fw.TILE_T)
    c = u[:, 0, :6].double().cpu().numpy() / tiles
    out[k] = {"warp0": np.median(c[:, :3], 0).round(0).tolist(),
              "warp4": np.median(c[:, 3:], 0).round(0).tolist()}
print(json.dumps(out))
"""


_BWD_PHASES = ("    // ---- A = tril(Linv) Kuf", "    // ---- dA = G A",
               "    // ---- dLinv += dA Kuf^T", "    // ---- dK = tril(Linv)^T dA",
               "    // ---- per-source sums")
_BWD_LOOP = "  for (int tile = begin; tile < end; ++tile) {\n"
_BWD_AFTER = "  // (a block without a tile has no chunk's parameters loaded"

_BWD_CHILD = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import importlib
import chip_smoke as cs
fw = importlib.import_module("gpitch_tpu_torch.linalg.fused_whiten")
dev = torch.device("cuda")
amt_f0 = 261.6 * 2 ** (np.arange(8) / 12)
sosp_f0 = 261.6 * 2 ** (np.array([0, 4, 7]) / 12)
cases = {"a_sosp": cs._whiten_inputs(222, 2001, 112, cs._harmonics(sosp_f0, 5, 16000.0),
                                     16000.0),
         "b_amt": cs._whiten_inputs(43, 2001, 160, cs._harmonics(amt_f0, 10, 44100.0),
                                    44100.0)}
names = ("zc", "xc", "err", "linv", "du", "dv", "energy", "freq", "var", "inv_l")
phases = ("build", "A", "GA", "dLinv", "dK", "sums")
out = {}
for k, d in cases.items():
    args = [torch.as_tensor(np.array(d[n]), dtype=torch.float32, device=dev) for n in names]
    for _ in range(2):
        dl = fw._backward_kernel(*args, splits=1)[0]
    torch.cuda.synchronize()
    tiles = -(-args[1].shape[-1] // fw.TILE_T)
    c = dl[:, 0, :12].double().cpu().numpy() / tiles
    out[k] = {"warp0": dict(zip(phases, np.median(c[:, :6], 0).round(0).tolist())),
              "warp2": dict(zip(phases, np.median(c[:, 6:], 0).round(0).tolist()))}
print(json.dumps(out))
"""


def instrument_bwd(src: str) -> str:
    """kernel B's source with a counter per phase; raises if an anchor is
    missing."""
    start = src.index("// ------------------------------------------------------------- kernel B")
    end = src.index("// out[w][e] = sum over splits of part[w][split][e]")
    head, body, tail = src[:start], src[start:end], src[end:]
    kern = body.index("fused_whiten_bwd_kernel(BwdArgs a) {")
    pre, body = body[:kern], body[kern:]
    i = body.index(_BWD_LOOP)
    body = (body[:i] + "  long long tp[6] = {0, 0, 0, 0, 0, 0}, c0 = 0, c1;\n" + _BWD_LOOP
            + "    c0 = clock64();\n" + body[i + len(_BWD_LOOP):])
    for n, anchor in enumerate(_BWD_PHASES):
        j = body.find(anchor)
        if j < 0:
            raise ValueError(f"anchor not found: {anchor.strip()!r}")
        body = body[:j] + f"    c1 = clock64(); tp[{n}] += c1 - c0; c0 = c1;\n" + body[j:]
    # the per-source sums end where the tile loop does: before the comment
    # after it, close the last phase inside the loop's closing brace
    j = body.index(_BWD_AFTER)
    k = body.rindex("  }\n", 0, j)
    body = body[:k] + "    tp[5] += clock64() - c0;\n" + body[k:]
    k = body.index("\n}\n", body.index(_BWD_AFTER))
    body = (body[:k] + "\n  __syncthreads();\n  if (threadIdx.x == 0 || threadIdx.x == 64)\n"
            "    for (int q = 0; q < 6; ++q) rec[(threadIdx.x == 0 ? 0 : 6) + q] = (float)tp[q];"
            + body[k:])
    return head + pre + body + tail


def instrument(src: str) -> str:
    """kernel A's source with the counters; raises if an anchor is missing."""
    def insert(text, anchor, before):
        i = text.find(anchor)
        if i < 0:
            raise ValueError(f"anchor not found: {anchor.strip()!r}")
        return text[:i] + before + text[i:]

    end_b = src.index("// ------------------------------------------------------------- kernel B")
    kernel_a = src.rindex("__global__", 0, end_b)
    head, body, tail = src[:kernel_a], src[kernel_a:end_b], src[end_b:]
    for anchor, before in _PATCHES:
        body = insert(body, anchor, before)
    i = body.index(_LOOP_TOP[0]) + len(_LOOP_TOP[0])
    body = body[:i] + _LOOP_TOP[1] + body[i:]
    k = body.rindex("}\n")
    body = body[:k] + _KERNEL_END + body[k:]
    return head + body + tail


def main() -> int:
    bwd = sys.argv[1:2] == ["--bwd"]
    trees = sys.argv[2:] if bwd else sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for n, tree in enumerate(trees):
        dst = os.path.join(ROOT, "build", "phase_clocks", str(n))
        shutil.rmtree(dst, ignore_errors=True)
        os.makedirs(dst)
        shutil.copytree(os.path.join(tree, "gpitch_tpu_torch"),
                        os.path.join(dst, "gpitch_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(tree, "chip_smoke.py"), dst)
        cu = os.path.join(dst, "gpitch_tpu_torch", "csrc", "fused_whiten.cu")
        with open(cu) as fh:
            src = fh.read()
        with open(cu, "w") as fh:
            fh.write(instrument_bwd(src) if bwd else instrument(src))
        res = subprocess.run([sys.executable, "-c", _BWD_CHILD if bwd else _CHILD, dst],
                             capture_output=True,
                             text=True, timeout=600, cwd=dst)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        cycles = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, "cycles_per_tile": cycles}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
