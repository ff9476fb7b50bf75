"""Build and load the CUDA kernels: the counterpart of the JAX package's
ops/kern/backend.py.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
an object, all sources at once in parallel, and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
Each C entry takes device pointers, sizes and a stream, and returns
``cudaGetLastError()``.

The build runs at first use, never at import, into
``build/kernels/<hash>/`` under the repository root, where the hash
covers every source and the compiler flags: a changed source builds
anew, an unchanged one loads what is there.  ``build.log`` beside the
library keeps ``ptxas``'s register and spill report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libhotstuff_kern.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes signatures of the C entries: pointers and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), sizes as the
# C types the entries declare.
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "hk_probe": [_P, _P, _I, _P],
    "hk_field_mul": [_P, _P, _P, _LL, _P],
    "hk_scalar_mont_mul": [_P, _P, _P, _LL, _P],
    "hk_msm_window_accum": [_P, _P, _P, _P, _I, _I, _P],
    "hk_point_ladder": [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
    "hk_decompress": [_P, _P, _P, _P, _LL, _P],
    "hk_point_multiples": [_P, _P, _LL, _I, _I, _P],
    "hk_rlc_scalars": [_P, _P, _P, _P, _P, _LL, _P],
    "hk_rlc_reduce": [_P, _P, _LL, _P],
    "hk_fq12_mul": [_P, _P, _P, _LL, _P],
    "hk_miller_accumulate": [_P, _P, _I, _P, _LL, _I, _P],
    "hk_fq12_pow": [_P, _P, _P, _LL, _I, _P],
    "hk_fq_pow": [_P, _P, _P, _LL, _I, _P],
    "hk_fq12_hard_pow": [_P, _P, _I, _P, _P, _I, _P, _I, _P, _LL, _P],
    "hk_final_exp": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _LL, _P],
    "hk_fq12_product": [_P, _I, _P, _I, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_hash: str | None = None  # source_hash() of the loaded library
build_seconds: float | None = None  # wall time of this process's build


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build hotstuff_tpu_torch's kernels")


def build() -> Path:
    """Compile the sources if this hash has no library yet; returns the
    library's path.  Raises with the compiler's output on failure."""
    global build_seconds
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    t0 = time.monotonic()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    compiler = nvcc()
    try:
        procs = []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = work / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        (work / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [compiler, "-shared", "-o", str(work / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        try:
            work.rename(out_dir)
        except OSError:
            # The rename fails when another process finished the same
            # build first; anything else is an error.
            if not lib.exists():
                raise
    finally:
        if work.exists():
            shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.monotonic() - t0
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (thread-safe)."""
    global _lib, _lib_hash
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib, _lib_hash = lib, path.parent.name
        return _lib


def loaded() -> bool:
    """True when this process has loaded the library of the current
    sources, so no launch can wait on a build."""
    return _lib is not None and _lib_hash == source_hash()


def build_log() -> str:
    """ptxas's report from the library's build, when it is on disk."""
    path = BUILD_ROOT / source_hash() / "build.log"
    return path.read_text() if path.exists() else ""
