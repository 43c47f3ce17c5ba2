"""Time tile shapes of ``linear_rows``' bfloat16 kernel on the card.

Builds one library that instantiates ``launch_linear_rows_bf16`` of
``csrc/linear_rows.cu`` at each shape of ``SHAPES`` (into
``build/repro_torch/tiles/``), then times each at glm4-9b's products
(M 3968 and 128; K-splits 1, 4 and ``k_splits(N, K)``) against
``torch.matmul``, and prints one JSON line per (K, N, M): the median ms
of 20 launches (CUDA events) of each shape and split.  A shape whose
output is off ``x @ w`` by a relative L2 error above 1e-2 prints
"bad".  The production shape is ``kLrBM ... kLrStages`` of the source::

    PYTHONPATH=src python -m repro_torch.kernels.linear_rows.tiles
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import torch

from repro_torch.kernels.build import (_CSRC, ARCH_FLAGS, BUILD_DIR,
                                       NVCC_FLAGS, _nvcc)
from repro_torch.kernels.linear_rows.ops import k_splits

# (BM, BN, BK, WM, WN, STAGES)
SHAPES = ((128, 128, 32, 64, 32, 4), (128, 128, 32, 64, 64, 4),
          (128, 256, 32, 64, 64, 3), (128, 128, 64, 64, 64, 3),
          (256, 128, 32, 64, 64, 3), (128, 256, 64, 64, 64, 3),
          (128, 128, 32, 32, 64, 4))
PRODUCTS = ((4096, 4096), (4096, 13696), (13696, 4096), (4096, 256))


def _source() -> str:
    cases = "\n".join(
        f"    case {i}: err = launch_linear_rows_bf16<{', '.join(map(str, s))}>"
        "(x, w, y, ws, M, N, K, S, st); break;" for i, s in enumerate(SHAPES))
    return f"""#include "linear_rows.cu"
using namespace repro;
extern "C" int tile_linear(int v, const void* x, const void* w, void* y,
                           float* ws, int M, int N, int K, int S, void* stream) {{
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (v) {{
{cases}
    default: return 1;
  }}
  if (err != cudaSuccess || S == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  linear_rows_combine_kernel<__nv_bfloat16><<<(unsigned)((mn / 4 + 255) / 256),
                                              256, 0, st>>>(ws, (__nv_bfloat16*)y, mn, S);
  return (int)cudaGetLastError();
}}
"""


def _library() -> ctypes.CDLL:
    out = BUILD_DIR / "tiles"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "tiles.cu", out / "libtiles.so"
    src.write_text(_source())
    subprocess.run([_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-shared", "-I",
                    str(_CSRC), str(src), "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.tile_linear.argtypes = [i, p, p, p, p, i, i, i, i, p]
    dll.tile_linear.restype = i
    return dll


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = _library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "shapes": SHAPES}), flush=True)
    for k, n in PRODUCTS:
        w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).bfloat16()
        for m in (3968, 128):
            x = torch.randn((m, k), generator=g, device=dev).bfloat16()
            ref = (x @ w).float()
            row = {"K": k, "N": n, "M": m,
                   "matmul": _ms(lambda: torch.matmul(x, w))}
            for s in sorted({1, 4, k_splits(n, k)}):
                ws = torch.empty((s, m, n), dtype=torch.float32, device=dev)
                y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                stream = torch.cuda.current_stream().cuda_stream
                for v in range(len(SHAPES)):
                    def call(v=v):
                        return lib.tile_linear(v, x.data_ptr(), w.data_ptr(),
                                               y.data_ptr(), ws.data_ptr(), m,
                                               n, k, s, stream)
                    err = call()
                    torch.cuda.synchronize()
                    if err:
                        row[f"v{v}S{s}"] = f"CUDA error {err}"
                        continue
                    rel = float((y.float() - ref).norm() / ref.norm())
                    row[f"v{v}S{s}"] = _ms(call) if rel < 1e-2 else "bad"
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
