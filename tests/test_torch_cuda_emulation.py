"""The CPU emulation of CUDA (tests/cuda_emulation/cuda_runtime.h) that the
emulated kernel tests build gpitch_tpu_torch/csrc/fused_whiten.cu against:
a block's threads as fibers in a fixed order, its barriers, named
barriers, warp shuffles and spins, and the guard that turns a deadlocked
block into a launch error.  Each case is a small kernel below, built once a
worker with g++ -std=c++20; skips where no g++ that takes it is found.
"""

import ctypes
import subprocess
import sys

import numpy as np
import pytest

from emulation_build import emulated_library

_SOURCE = r"""
#include <cuda_runtime.h>

// Each thread stores its index; before the barrier it reads the next
// thread's slot (a later thread's is not yet written: NaN), after it the
// slot is filled.  Three blocks: shared memory starts as NaN in each.
__global__ void barrier_kernel(float* before, float* after) {
  GPITCH_DYNAMIC_SHARED(sm);
  const int t = threadIdx.x, nt = blockDim.x, o = blockIdx.x * nt + t;
  sm[t] = static_cast<float>(t);
  before[o] = sm[(t + 1) % nt];
  __syncthreads();
  after[o] = sm[(t + 1) % nt];
}

// Threads 64-127 meet at named barrier 3 (64 of the block's 128), then
// arrive at barrier 4, where threads 0-63 wait: each logs its turn.
__global__ void named_kernel(int* turn, int* log) {
  const int t = threadIdx.x;
  if (t >= 64) {
    named_sync(3, 64);
    log[t] = (*turn)++;
    named_arrive(4, 128);
  } else {
    named_sync(4, 128);
    log[t] = (*turn)++;
  }
}

// Lane t of two warps, offsets 1-16: the value of lane t ^ off.
__global__ void shuffle_kernel(float* out) {
  const int t = threadIdx.x;
  for (int off = 1; off <= 16; ++off) out[t * 16 + off - 1] = __shfl_xor_sync(~0u, t, off);
}

// Thread 0 of block 1 spins on a counter that block 0 and its own block's
// other threads count; the block then meets at a barrier.
__global__ void spin_kernel(int* counter, int* seen) {
  if (blockIdx.x == 1 && threadIdx.x == 0) {
    const volatile int* c = counter;
    while (*c < 2 * static_cast<int>(blockDim.x) - 1) __nanosleep(128);
    *seen = *c;
  } else {
    atomicAdd(counter, 1);
  }
  __syncthreads();
}

// A barrier that half the block never reaches, or a spin that nothing ends.
__global__ void deadlock_kernel(int kind, int* flag) {
  if (kind == 0) {
    if (threadIdx.x < 128) __syncthreads();
  } else {
    if (threadIdx.x == 5)
      while (*static_cast<volatile int*>(flag) == 0) __nanosleep(128);
    __syncthreads();
  }
}

extern "C" int barrier_order(float* before, float* after) {
  GPITCH_LAUNCH(barrier_kernel, 3, 256, 0, nullptr)(before, after);
  return cudaGetLastError();
}
extern "C" int named_order(int* log) {
  int turn = 0;
  GPITCH_LAUNCH(named_kernel, 1, 128, 0, nullptr)(&turn, log);
  return cudaGetLastError();
}
extern "C" int shuffles(float* out) {
  GPITCH_LAUNCH(shuffle_kernel, 1, 64, 0, nullptr)(out);
  return cudaGetLastError();
}
extern "C" int spin(int* seen) {
  int counter = 0;
  GPITCH_LAUNCH(spin_kernel, 2, 256, 0, nullptr)(&counter, seen);
  return cudaGetLastError();
}
extern "C" int deadlock(int kind) {
  int flag = 0;
  GPITCH_LAUNCH(deadlock_kernel, 2, 256, 0, nullptr)(kind, &flag);
  return cudaGetLastError();
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    src = tmp_path_factory.mktemp("emulation") / "emulation_cases.cpp"
    src.write_text(_SOURCE)
    so = emulated_library(tmp_path_factory, src)
    for fn, argtypes in {"barrier_order": [ctypes.c_void_p] * 2, "named_order": [ctypes.c_void_p],
                         "shuffles": [ctypes.c_void_p], "spin": [ctypes.c_void_p],
                         "deadlock": [ctypes.c_int]}.items():
        getattr(so, fn).argtypes = argtypes
        getattr(so, fn).restype = ctypes.c_int
    return so


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_block_barrier_orders_writes_before_reads(lib):
    """Before __syncthreads a thread finds the next thread's slot NaN (the
    last thread finds thread 0's store: the fixed order); after it, every
    slot is stored.  Each of three blocks starts from NaN."""
    before, after = np.zeros(3 * 256, np.float32), np.zeros(3 * 256, np.float32)
    assert lib.barrier_order(_ptr(before), _ptr(after)) == 0
    want = (np.arange(256) + 1) % 256
    for b in range(3):
        assert np.isnan(before[b * 256:b * 256 + 255]).all()
        assert before[b * 256 + 255] == 0.0
        np.testing.assert_array_equal(after[b * 256:(b + 1) * 256], want)


def test_named_barrier_with_fewer_threads_releases_only_its_waiters(lib):
    """Named barrier 3 (64 of 128 threads) releases threads 64-127 and not
    threads 0-63, which wait at barrier 4 until those 64 arrive: threads
    64-127 take turns 0-63, in order, and threads 0-63 turns 64-127."""
    log = np.full(128, -1, np.int32)
    assert lib.named_order(_ptr(log)) == 0
    np.testing.assert_array_equal(log, np.r_[np.arange(64, 128), np.arange(64)])


def test_shfl_xor_sync_exchanges_lanes_at_every_offset(lib):
    """Each lane of two warps gets lane ^ off of its own warp, offsets 1-16."""
    out = np.zeros((64, 16), np.float32)
    assert lib.shuffles(_ptr(out)) == 0
    t, off = np.arange(64)[:, None], np.arange(1, 17)[None, :]
    np.testing.assert_array_equal(out, (t // 32) * 32 + ((t % 32) ^ off))


def test_spin_with_nanosleep_ends(lib):
    """A thread's spin on a counter, with __nanosleep, ends once block 0's
    256 threads and its own block's other 255 have counted."""
    seen = np.zeros(1, np.int32)
    assert lib.spin(_ptr(seen)) == 0
    assert seen[0] == 511


@pytest.mark.parametrize("kind,waits", [
    (0, "threads 0-127 __syncthreads; threads 128-255 ended;"),
    (1, "threads 0-4 __syncthreads; threads 5-5 __nanosleep; threads 6-255 __syncthreads;")],
    ids=["half_the_block_at_a_barrier", "a_spin_nothing_ends"])
def test_deadlock_guard_reports_the_block_and_fails_the_launch(lib, kind, waits):
    """A barrier that half the block never reaches, or a spin that nothing
    ends: the launch returns cudaErrorLaunchFailure (719) within seconds,
    stderr names block (0, 0) and each thread's wait, no later block runs,
    and the process goes on: its next launch succeeds.  Run in a child
    process, so that a guard that fails hangs only the child, to its
    timeout."""
    code = ("import ctypes, sys, numpy as np; so = ctypes.CDLL(sys.argv[1]); "
            "out = np.zeros(64 * 16, np.float32); "
            f"print(so.deadlock({kind}), so.shuffles(out.ctypes.data_as(ctypes.c_void_p)))")
    res = subprocess.run([sys.executable, "-c", code, lib._name], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["719", "0"]
    assert res.stderr.strip() == f"cuda emulation: deadlock in block (0, 0): {waits}"
