"""Build and load the port's CUDA kernels.

Each source ``gpitch_tpu_torch/csrc/<name>.cu`` has a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>.so``
at the repository root (git-ignored), at first use, then loaded with
ctypes.  Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import types
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "build", "load", "check", "counted",
           "counter", "launch_counts", "record_capture", "record_replays", "device_launches",
           "reset_launches", "graph_nodes", "GraphChain"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# name -> {C function: argtypes}; every function returns a cudaError_t as int
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    # K, L, scratch, B, M, panel, stream; the scratch query: M, panel, elem
    "chol": {"gpitch_chol_f32": [_P, _P, _P, _L, _I, _I, _P],
             "gpitch_chol_f64": [_P, _P, _P, _L, _I, _I, _P],
             "gpitch_chol_scratch": [_I, _I, _I]},
    # x, x2, energy, freq, var, ls, feature workspace, out; B, S, N, M, P,
    # m32, sum_sources; stream.  The workspace query: N, M, P
    "specmix": {"gpitch_specmix_f32": [_P] * 8 + [_L, _I, _I, _I, _I, _I, _I, _P],
                "gpitch_specmix_f64": [_P] * 8 + [_L, _I, _I, _I, _I, _I, _I, _P],
                "gpitch_specmix_workspace": [_I, _I, _I]},
    # inputs, partial sums, output, scratch (the backward: partial records,
    # their sum, scratch); window strides of (S, P) and (S,)
    # parameters; nw, M, N, S, P, splits; stream.  The split plan: backward?,
    # nw, M, N, S, P -> splits; each kernel's scratch floats per window: M, S, P;
    # whether kernel B takes its role-split body: M, S, P; the source chunks a
    # launch walks: backward?, M, S, P
    "fused_whiten": {"gpitch_fused_whiten_fwd": [_P] * 11 + [_I] * 8 + [_P],
                     "gpitch_fused_whiten_fwd_workspace": [_I] * 3,
                     "gpitch_fused_whiten_bwd": [_P] * 13 + [_I] * 8 + [_P],
                     "gpitch_fused_whiten_bwd_workspace": [_I] * 3,
                     "gpitch_fused_whiten_splits": [_I] * 6 + [ctypes.POINTER(_I)],
                     "gpitch_fused_whiten_bwd_roles": [_I] * 3,
                     "gpitch_fused_whiten_source_chunks": [_I] * 4},
    # a graph's top-level nodes; the chain of n parts (graphs, conditions,
    # the new graph and its executable out); launch (executable, stream); free
    "graphs": {"gpitch_graph_nodes": [_P, ctypes.POINTER(ctypes.c_longlong)],
               "gpitch_graph_chain": [_I, ctypes.POINTER(_P), ctypes.POINTER(_P),
                                      ctypes.POINTER(_P), ctypes.POINTER(_P)],
               "gpitch_graph_launch": [_P, _P],
               "gpitch_graph_free": [_P, _P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so, src = _library(name), CSRC_DIR / f"{name}.cu"
    return not so.exists() or src.stat().st_mtime > so.stat().st_mtime


def build(names=tuple(SIGNATURES)) -> list[str]:
    """Compile the named kernels that are missing or older than their source,
    one ``nvcc`` process each, all started together.  Returns the names
    built; raises with the compiler's output if one fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu ---\n{out}")
            continue
        os.replace(tmp, _library(n))        # atomic: concurrent builders agree
        (BUILD_DIR / f"{n}.ptxas.txt").write_text(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (the C side returns
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# The kernel wrappers that count their launches: each adds one to its
# ``launches`` where it launches its kernel.  A call made while a CUDA graph
# is captured records the launch into the graph and launches nothing; the
# graph's replays launch it again without the wrapper.  ``GRAPHS`` keeps,
# per wrapper, the calls recorded into graphs and the launches of their
# replays, so that ``device_launches`` counts what ran on the card.
COUNTED: dict = {}
GRAPHS = {"graphs": 0, "replays": 0, "host_points": 0, "recorded": {}, "replayed": {}}


def counted(fn):
    """Register the kernel wrapper ``fn``, its ``launches`` set to 0."""
    fn.launches = 0
    COUNTED[fn.__name__] = fn
    return fn


def counter(name: str):
    """A launch count registered as ``counted`` registers a wrapper's, for
    a kernel body that a wrapper chooses: its ``launches`` set to 0."""
    return counted(types.SimpleNamespace(__name__=name))


def launch_counts() -> dict:
    """Each registered wrapper's ``launches``, by name."""
    return {name: fn.launches for name, fn in COUNTED.items()}


def record_capture(calls: dict, host_points: int = 0) -> None:
    """One graph (or one step split at ``host_points`` host all-reduces)
    captured, holding ``calls`` (wrapper name -> calls made while
    capturing)."""
    GRAPHS["graphs"] += 1
    GRAPHS["host_points"] += host_points
    for name, n in calls.items():
        GRAPHS["recorded"][name] = GRAPHS["recorded"].get(name, 0) + n


def record_replays(calls: dict, replays: int) -> None:
    """``replays`` replays of a graph that holds ``calls``."""
    GRAPHS["replays"] += replays
    for name, n in calls.items():
        GRAPHS["replayed"][name] = GRAPHS["replayed"].get(name, 0) + n * replays


def device_launches() -> dict:
    """Each registered kernel's launches on the card since
    ``reset_launches``: its wrapper's count, less the calls recorded into
    graphs, plus the replays' launches."""
    return {name: n - GRAPHS["recorded"].get(name, 0) + GRAPHS["replayed"].get(name, 0)
            for name, n in launch_counts().items()}


def reset_launches() -> None:
    """Every registered wrapper's count and ``GRAPHS`` set to 0."""
    for fn in COUNTED.values():
        fn.launches = 0
    GRAPHS.update(graphs=0, replays=0, host_points=0, recorded={}, replayed={})


def graph_nodes(graph) -> int:
    """The top-level nodes of a PyTorch CUDA graph captured with
    ``keep_graph=True``."""
    count = ctypes.c_longlong()
    check(load("graphs").gpitch_graph_nodes(graph.raw_cuda_graph(), ctypes.byref(count)),
          "gpitch_graph_nodes")
    return count.value


class GraphChain:
    """PyTorch CUDA graphs run one after another as one CUDA graph
    (``csrc/graphs.cu``), each part given as (graph, condition): a graph
    captured with ``keep_graph=True``, and None or a 0-d bool CUDA tensor.
    A part with a condition runs only where the tensor holds when the part
    is reached, decided on the device by a CUDA IF node; the host reads
    nothing.  ``replay()`` launches the chain on the current stream.  The
    parts are cloned into the chain, but their memory (the pool of their
    capture) is theirs: keep the graphs while the chain is used.
    ``nodes``: the chain's nodes, the parts' included."""

    def __init__(self, parts):
        self._lib = lib = load("graphs")
        n = len(parts)
        graphs = (_P * n)(*[g.raw_cuda_graph() for g, _ in parts])
        preds = (_P * n)(*[None if c is None else c.data_ptr() for _, c in parts])
        self._graph, self._exec = _P(), _P()
        check(lib.gpitch_graph_chain(n, graphs, preds, ctypes.byref(self._graph),
                                     ctypes.byref(self._exec)), "gpitch_graph_chain")
        self.nodes = sum(graph_nodes(g) + (0 if c is None else 2) for g, c in parts)

    def replay(self) -> None:
        import torch
        stream = torch.cuda.current_stream().cuda_stream
        check(self._lib.gpitch_graph_launch(self._exec, stream), "gpitch_graph_launch")

    def __del__(self):
        if self._exec:
            self._lib.gpitch_graph_free(self._graph, self._exec)
