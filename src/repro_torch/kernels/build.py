"""Build and load the port's CUDA kernels.

The sources under ``src/repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use (never at import): every source
is compiled to an object by its own ``nvcc`` process, all started
together, then one link.  The library lands in ``build/repro_torch/`` at
the repository root, named by a hash of the sources and flags, so an
unchanged tree builds once.

Run alone to build and print the seconds it took::

    python -m repro_torch.kernels.build
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_LIB: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, pad, out, lse, B, S, Hq, Hk, D, causal, window, dtype, stream
    "repro_flash_attn": [_P] * 6 + [_I] * 8 + [_P],
    # q, k, v, o, do, lse, delta, dq, dk, dv, split, ktile, ws, B, S, Hq,
    # Hk, D, n_split, dtype, stream
    "repro_flash_attn_bwd": [_P] * 13 + [_I] * 7 + [_P],
    # out[2]: the bf16 backward's row and key tiles
    "repro_flash_attn_bwd_tile": [_P],
    # q, k, v, lengths, pad, out, B, T, Smax, Hq, Hk, D, window, tree_w,
    # tree_g, dtype, stream
    "repro_verify_attn": [_P] * 6 + [_I] * 10 + [_P],
    # q, k_pool, v_pool, tbl, pad, out, B, S, n_tbl, P, Hq, Hk, D, causal,
    # window, dtype, stream
    "repro_flash_attn_paged": [_P] * 6 + [_I] * 10 + [_P],
    # q, k_pool, v_pool, tbl, lengths, pad, out, B, T, n_tbl, P, Hq, Hk, D,
    # window, tree_w, tree_g, dtype, stream
    "repro_verify_attn_paged": [_P] * 7 + [_I] * 11 + [_P],
    # feats, tokens, mask, pf, pt, cnt, B, T, F, elem_bytes, stream
    "repro_extract_pack": [_P] * 6 + [_I] * 4 + [_P],
    # x, w, y, ws, M, N, K, splits, dtype, stream
    "repro_linear_rows": [_P] * 4 + [_I] * 5 + [_P],
    # out: BM, BN, BK, STAGES of the bf16 tile
    "repro_linear_rows_tile": [_P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global BUILD_SECONDS
    sources = sorted(_CSRC.glob("*.cu"))
    tag = _digest()
    lib = BUILD_DIR / f"librepro_torch_{tag}.so"
    if lib.exists():
        BUILD_SECONDS = 0.0
        return lib
    t0 = time.perf_counter()
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(_CSRC), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    objs, errors = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = obj_dir / lib.name
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o",
                           str(tmp)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib)
    shutil.rmtree(obj_dir, ignore_errors=True)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str):
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


if __name__ == "__main__":
    path = build()
    print(f"{path} built in {BUILD_SECONDS:.1f} s")
