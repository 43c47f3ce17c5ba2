"""Time ``linear_rows``' bfloat16 kernel on the card: its tile shapes,
and the wrapper's host time apart from its device time.

Builds one library that instantiates ``launch_linear_rows_bf16`` of
``csrc/linear_rows.cu`` (the wgmma kernel fed by TMA; 128 rows a block)
at each (column tile BN, ring stages) of ``SHAPES`` (into
``build/repro_torch/tiles/``), then times each at glm4-9b's products
(M 3968 and 128; K-splits 1, 2, 4 and ``k_splits(N, K)``, as far as the
K chunks go) against ``torch.matmul``, and prints one JSON line per
(K, N, M): the median ms of 20 launches (CUDA events) of each shape and
split through the C entry, keyed ``BN<bn>x<stages>S<s>``.  A shape
whose output is off ``x @ w`` by a relative L2 error above 1e-2 prints
"bad".  The production shape is ``kLrBN``, ``kLrStages`` of the source.
BN 128 stays in ``SHAPES`` as the measured alternative to the
production BN 256, the one a fixed (N, K)-keyed variant for narrow
products would take.

The same line splits one call of the production path three ways:
``wrapper_ms``, CUDA events around one ``ops.linear_rows`` call (what
chip_smoke.py reads); ``device_ms``, the kernels' own time per call
from ``torch.profiler``, read after every other number (obs/timing.py);
``wrapper_host_ms`` and ``entry_host_ms``, the host's time per call of
the wrapper and of the bare C entry (tensor-map encodes and launch),
20 calls enqueued without a sync.  Where a host time exceeds the device
time, the event time reads the host::

    PYTHONPATH=src python -m repro_torch.kernels.linear_rows.tiles

``--wrapper`` prints only the wrapper's split and needs nothing of this
module's build, so the same file, copied into another tree's package
with ``obs/timing.py``, reads that tree's ``linear_rows``.

What it read on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md, kernel
table row 7): at M 3968 and S 1, BN 256 with 4 stages was the fastest
shape at q/o (0.209 ms; torch.matmul 0.197), ffn up/gate (0.698;
0.607) and ffn_down (0.623; 0.641), BN 128 was 14-20 % slower, and
every split of those products cost 17-70 %: the tensor cores bound
them, and a block's lone ring fill and epilogue hold them at
635-715 TFLOP/s.  At M 128 BN 128 was fastest, at S 1 or 2 (16-54
blocks of BN 256 at S 1 leave most of the 132 SMs idle), but no shape
or split may follow M.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels.build import (_CSRC, ARCH_FLAGS, BUILD_DIR,
                                       NVCC_FLAGS, _nvcc)
from repro_torch.kernels.linear_rows.ops import BLOCK_K, k_splits, linear_rows
from repro_torch.obs.timing import event_ms, host_ms, resolve, split_ms

# (BN, STAGES): column tile and ring depth (a stage is 16 KB of x and
# BN·128 bytes of w; the ring fits 227 KB)
SHAPES = ((128, 4), (128, 6), (256, 3), (256, 4))
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    shapes = "--wrapper" not in sys.argv[1:]
    lib = production = None
    if shapes:
        from repro_torch.kernels.linear_rows.ops import tile
        lib, production = _library(), tile()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    ops_file = sys.modules[linear_rows.__module__].__file__
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "linear_rows": ops_file,
                      "shapes": SHAPES if shapes else None}), flush=True)
    rows = []
    for k, n in PRODUCTS:
        w = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5).bfloat16()
        for m in (3968, 128):
            x = torch.randn((m, k), generator=g, device=dev).bfloat16()
            ref = (x @ w).float()
            split = split_ms(lambda x=x, w=w: linear_rows(x, w),
                             ("linear_rows",))
            row = {"K": k, "N": n, "M": m, "S": k_splits(n, k),
                   "matmul": event_ms(lambda: torch.matmul(x, w)),
                   "wrapper_ms": split["ms"], "device_ms": split["device_ms"],
                   "wrapper_host_ms": split["host_ms"]}
            rows.append(row)
            if not shapes:
                continue
            chunks = -(-k // BLOCK_K)
            splits = {1, 2, 4, k_splits(n, k)}
            stream = torch.cuda.current_stream().cuda_stream
            for s in sorted(p for p in splits if p <= chunks):
                ws = torch.empty((s, m, n), dtype=torch.float32, device=dev)
                y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                for v, (bn, stages) in enumerate(SHAPES):
                    key = f"BN{bn}x{stages}S{s}"
                    def call(v=v):
                        return lib.tile_linear(v, x.data_ptr(), w.data_ptr(),
                                               y.data_ptr(), ws.data_ptr(), m,
                                               n, k, s, stream)
                    err = call()
                    torch.cuda.synchronize()
                    if err:
                        row[key] = f"CUDA error {err}"
                        continue
                    rel = float((y.float() - ref).norm() / ref.norm())
                    row[key] = event_ms(call) if rel < 1e-2 else "bad"
                    if s == k_splits(n, k) and (bn, stages) == (
                            production["BN"], production["STAGES"]):
                        row["entry_host_ms"] = host_ms(call)
    # the profiler's reads last (obs/timing.py)
    for row in resolve(rows):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
