"""field25519_lanes.cuh on the host, for the layout tests: a warp's 32
lanes as 32 threads that meet at every shuffle and ballot, built with
the host's C++ compiler into a ctypes library.

A test passes its own ``extern "C"`` entry points, written after
``SHIM`` (which includes the header and names ``hk::lanes`` as ``hl``),
to ``build``.  ``shuffles`` counts the warp's shuffles (lane 0's) from
the last time an entry point set it to 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import pytest

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "hotstuff_tpu_torch", "ops", "kern", "csrc")

SHIM = r"""
#include <barrier>
#include <thread>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __constant__
struct int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return int4{a, b, c, d}; }

// One warp: 32 threads that meet at every shuffle and ballot; lane 0
// counts the warp's shuffles.
static std::barrier<>* warp_barrier;
static int exchange[32];
static long long shuffles;
thread_local int lane_id;

inline int __shfl_sync(unsigned, int v, int src, int width = 32) {
  if (lane_id == 0) ++shuffles;
  exchange[lane_id] = v;
  warp_barrier->arrive_and_wait();
  const int r = exchange[(lane_id & ~(width - 1)) + (src & (width - 1))];
  warp_barrier->arrive_and_wait();
  return r;
}

inline unsigned __ballot_sync(unsigned, bool p) {
  exchange[lane_id] = p;
  warp_barrier->arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (exchange[i] ? 1u : 0u) << i;
  warp_barrier->arrive_and_wait();
  return m;
}

#include "field25519_lanes.cuh"

namespace hl = hk::lanes;
"""


def build(tmp_path_factory, name: str, entry_points: str) -> ctypes.CDLL:
    """``SHIM`` and ``entry_points`` compiled into a ctypes library under a
    temporary folder ``name``; skips the test where no host C++ compiler
    is found."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    work = tmp_path_factory.mktemp(name)
    (work / "harness.cpp").write_text(SHIM + entry_points)
    lib = work / "libharness.so"
    subprocess.run([cxx, "-O2", "-std=c++20", "-shared", "-fPIC", "-pthread",
                    f"-I{CSRC}", str(work / "harness.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))
