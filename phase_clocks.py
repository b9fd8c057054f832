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

does the same for kernel B (the AMT widths too: ``c_amt63``, 87 windows,
M 160, 63 x 20), whose tiles take six phases: the build of
Kuf's tile (``// ---- the build``), A = tril(Linv) Kuf (``// ---- A =
tril(Linv) Kuf``), dA = G A + dv err^T (``// ---- dA = G A``), dLinv +=
dA Kuf^T (``// ---- dLinv += dA Kuf^T``), dK = tril(Linv)^T dA (``// ----
dK = tril(Linv)^T dA``) and the per-source sums (``// ---- per-source
sums``): the cycles per tile of warps 0 and 2 from each comment to the
next (the first from the tile's start, the last to its end); the counters
overwrite dLinv[w, 0, :12].  Where a tree's kernel B has the role-split
body (``fused_whiten_bwd_kernel(BwdArgs a, RoleSplit)``, which serves the
SoSp width; the AMT width keeps the present body), that body is clocked by
role at its own comments instead, at its own plan of blocks: warp 0 of the
consumers in the wait for Kuf (``// ---- consumers wait for Kuf``), A
(``// ---- A = tril(Linv) Kuf``), G A (``// ---- dA = G A``), dLinv
(``// ---- dLinv += dA Kuf^T``) and dK with its store and handoff (``//
---- dK = tril(Linv)^T dA``), into dLinv[w, 0, :5]; warp 0 of the
producers in the wait for dK (``// ---- producers wait for dK``), the sums
(``// ---- per-source sums of dK``) and the builds (``// ---- the build of
tile t + 2``, and the two before the loop), into de[w].  A wait is settled
by a shared load before its clock is read (a barrier's wait is deferred to
a later instruction).  Each counter is summed over the blocks that cover a
window (the records' sum) and divided by the window's tiles: cycles a
64-sample tile of one block, alone on its SM.  Where kernel B takes its
two-phase body (M 160 over several build chunks), its phase-1 items are
clocked as the present body's tiles (the last phase the store of dK's
tile; summed over the window's items at the body's own plan), and each
phase-2 item's warp 0 at its own comments: the item's start and the wait at
each tile's first barrier, W = dK E (``// ---- W = dK E``), the x features
and the barrier after them (``// ---- the tile's x features``), the three
products (``// ---- the three products``) and the item's end, into de[w,
s0, :5]; the median over items, divided by the window's tiles: cycles a
32-sample tile of one item.  Needs a CUDA card.
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
                                    44100.0),
         "c_amt63": cs._whiten_inputs(87, 2001, 160, cs._harmonics(
             27.5 * 2 ** (np.arange(63) / 12), 20, 44100.0), 44100.0)}
names = ("zc", "xc", "err", "linv", "du", "dv", "energy", "freq", "var", "inv_l")
phases = ("build", "A", "GA", "dLinv", "dK", "sums")
items = ("start_wait", "W", "xfeat", "products", "end")
out = {}
for k, d in cases.items():
    args = [torch.as_tensor(np.array(d[n]), dtype=torch.float32, device=dev) for n in names]
    roles = hasattr(fw, "_roles") and fw._roles(args[0].shape[1], *args[6].shape[-2:])
    si = fw._phases(args[0].shape[1], *args[6].shape[-2:]) if hasattr(fw, "_phases") else 0
    for _ in range(2):
        rec = fw._backward_kernel(*args, splits=None if roles or si else 1)
    torch.cuda.synchronize()
    if roles:
        tiles = -(-args[1].shape[-1] // fw.ROLE_TILE_T)
        c = np.median(rec[0][:, 0, :5].double().cpu().numpy() / tiles, 0).round(0).tolist()
        q = rec[3].reshape(len(rec[3]), -1)[:, :3].double().cpu().numpy() / tiles
        q = np.median(q, 0).round(0).tolist()
        out[k] = {"samples_per_tile": fw.ROLE_TILE_T,
                  "consumer_warp0": dict(zip(("wait_kuf", "A", "GA", "dLinv",
                                              "dK_store_handoff"), c)),
                  "producer_warp0": dict(zip(("wait_dk", "sums", "build"), q))}
        continue
    tiles = -(-args[1].shape[-1] // fw.TILE_T)
    c = rec[0][:, 0, :12].double().cpu().numpy() / tiles
    out[k] = {"warp0": dict(zip(phases, np.median(c[:, :6], 0).round(0).tolist())),
              "warp2": dict(zip(phases, np.median(c[:, 6:], 0).round(0).tolist()))}
    if si:
        z = rec[3][:, ::si, :5].double().cpu().numpy().reshape(-1, 5) / tiles
        out[k]["phase2_item_warp0_per_tile"] = dict(zip(items, np.median(z, 0).round(0).tolist()))
        out[k]["sources_a_phase2_item"] = si
print(json.dumps(out))
"""


def instrument_bwd(src: str) -> str:
    """kernel B's source with a counter per phase; raises if an anchor is
    missing."""
    start = src.index("// ------------------------------------------------------------- kernel B")
    end = src.index("// out[w][e] = sum over splits of part[w][split][e]")
    head, body, tail = src[:start], src[start:end], src[end:]
    # the present body's tiles: a function of their own where the two-phase
    # body's phase 1 shares them (bwd_tiles), else the kernel itself
    kern = body.find("void bwd_tiles(")
    if kern < 0:
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
    # after it, close the last phase inside the loop's closing brace (and at
    # phase 1's ``continue`` after its dK store)
    j = body.index(_BWD_AFTER)
    i = body.find("      continue;\n", body.index(_BWD_PHASES[-1]), j)
    if i >= 0:
        body = body[:i] + "      tp[5] += clock64() - c0;\n" + body[i:]
        j = body.index(_BWD_AFTER)
    k = body.rindex("  }\n", 0, j)
    body = body[:k] + "    tp[5] += clock64() - c0;\n" + body[k:]
    k = body.index("\n}\n", body.index(_BWD_AFTER))
    body = (body[:k] + "\n  __syncthreads();\n  if (threadIdx.x == 0 || threadIdx.x == 64)\n"
            "    for (int q = 0; q < 6; ++q) rec[(threadIdx.x == 0 ? 0 : 6) + q] = (float)tp[q];"
            + body[k:])
    return head + pre + body + tail


# A barrier's wait is deferred to a later instruction (BAR.SYNC.DEFER_BLOCKING):
# a shared load that a branch depends on settles it before the clock is read
_SETTLE = "    if (*reinterpret_cast<volatile float*>(sm + l.z) == 1.25e30f) c0 -= 1;\n"
_ROLE_CONS = ("    // ---- consumers wait for Kuf", "    // ---- A = tril(Linv) Kuf",
              "    // ---- dA = G A", "    // ---- dLinv += dA Kuf^T", "    // ---- dK = tril(Linv)^T dA")
_ROLE_PROD = ("    // ---- producers wait for dK", "    // ---- per-source sums of dK",
              "    // ---- the build of tile t + 2")


def instrument_roles(src: str) -> str:
    """kernel B's role-split body with its counters by role (the source
    unchanged where it has no such body); raises if an anchor is missing."""
    start = src.find("__device__ void role_consumer(")
    if start < 0:
        return src
    end = src.index("fused_whiten_bwd_kernel(BwdArgs a, RoleSplit)")
    head, body, tail = src[:start], src[start:end], src[end:]

    def at(text, anchor, before, frm):
        i = text.find(anchor, frm)
        if i < 0:
            raise ValueError(f"anchor not found: {anchor.strip()!r}")
        return text[:i] + before + text[i:]

    def close(text, frm, record, last, write):
        """the last phase closed at the end of the tile loop before
        `record`, and `write` added at the end of the function"""
        rec = text.index(record, frm)
        k = text.rindex("  }\n", frm, rec)
        text = text[:k] + f"    {last} += clock64() - c0;\n" + text[k:]
        fin = text.index("\n}\n", text.index(record, frm))
        return text[:fin] + write + text[fin:]

    # consumers: the wait for Kuf and the four products
    n = len(_ROLE_CONS)
    cons = body.index("__device__ void role_consumer(")
    body = at(body, "  float* at = sm + l.at;\n", f"  long long tp[{n}] = {{}}, c0 = 0, c1;\n", cons)
    body = at(body, _ROLE_CONS[0], "    c0 = clock64();\n", cons)
    for k, anchor in enumerate(_ROLE_CONS[1:]):
        body = at(body, anchor, (_SETTLE if k == 0 else "")
                  + f"    c1 = clock64(); tp[{k}] += c1 - c0; c0 = c1;\n", cons)
    body = close(body, cons, "  // ---- consumers' record", f"tp[{n - 1}]",
                 "\n  named_sync(kBarCons, kCons);\n  if (threadIdx.x == CONS_FIRST)\n"
                 f"    for (int q = 0; q < {n}; ++q) rec[q] = (float)tp[q];")
    # producers: the wait for dK, the sums and the builds (the first two too)
    prod = body.index("__device__ void role_producer(")
    body = at(body, "  for (int t = tb; t < te && t < tb + 2; ++t)",
              "  long long tq[3] = {}, c0 = clock64(), c1;\n", prod)
    body = at(body, "  for (int t = tb; t < te; ++t) {\n", "  c1 = clock64(); tq[2] += c1 - c0;\n",
              prod)
    body = at(body, _ROLE_PROD[0], "    c0 = clock64();\n", prod)
    body = at(body, _ROLE_PROD[1], _SETTLE + "    c1 = clock64(); tq[0] += c1 - c0; c0 = c1;\n",
              prod)
    body = at(body, _ROLE_PROD[2], "    c1 = clock64(); tq[1] += c1 - c0; c0 = c1;\n", prod)
    body = close(body, prod, "  // ---- producers' record", "tq[2]",
                 "\n  named_sync(kBarProd, kProd);\n  if (threadIdx.x == PROD_FIRST)\n"
                 "    for (int q = 0; q < 3; ++q) rde[q] = (float)tq[q];")
    # the first thread of each role, where the body names it
    cons_first, prod_first = (("kConsFirst", "kProdFirst") if "kConsFirst" in src
                              else ("0", "kCons"))
    body = body.replace("CONS_FIRST", cons_first).replace("PROD_FIRST", prod_first)
    return head + body + tail


_SUMS_SETTLE = "    if (*reinterpret_cast<volatile float*>(sm + l.z) == 1.25e30f) c0 -= 1;\n"
_SUMS_PHASES = ("    // ---- W = dK E", "    // ---- the tile's x features",
                "    // ---- the three products")
_SUMS_AFTER = "  // ---- the z features once"


def instrument_phases(src: str) -> str:
    """kernel B's two-phase body with counters in its phase-2 items (the
    source unchanged where it has no such body): the item's start and each
    tile's wait at its first barrier, W = dK E, the x features with the
    barrier after them, the three products, and the item's end (the z
    features, the lanes' sums, the record), thread 0's cycles into de[w,
    s0, :5]; raises if an anchor is missing."""
    start = src.find("__device__ void bwd_sums(")
    if start < 0:
        return src
    end = src.index("\n}\n", start) + 3
    head, body, tail = src[:start], src[start:end], src[end:]

    def at(text, anchor, before):
        i = text.find(anchor)
        if i < 0:
            raise ValueError(f"anchor not found: {anchor.strip()!r}")
        return text[:i] + before + text[i:]

    body = at(body, "  const bool active = ",
              "  long long tz[5] = {}, c0 = clock64(), c1;\n")
    for k, anchor in enumerate(_SUMS_PHASES):
        body = at(body, anchor, (_SUMS_SETTLE if k != 1 else "")
                  + f"    c1 = clock64(); tz[{k}] += c1 - c0; c0 = c1;\n")
    j = body.index(_SUMS_AFTER)
    k = body.rindex("  }\n", 0, j)
    body = body[:k] + "    c1 = clock64(); tz[3] += c1 - c0; c0 = c1;\n" + body[k:]
    k = body.rindex("}\n")
    body = (body[:k] + "  __syncthreads();\n  tz[4] += clock64() - c0;\n"
            "  if (threadIdx.x == 0)\n"
            "    for (int q = 0; q < 5; ++q) rde[s0 * P + q] = (float)tz[q];\n" + body[k:])
    return head + body + tail


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
            fh.write(instrument_phases(instrument_roles(instrument_bwd(src))) if bwd
                     else instrument(src))
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
