"""Time ``pack_signals`` on the card at the glm4-9b main-path shape:
feats (8, 4, 12288) bf16, tokens (8, 4) int32, a mask of density 0.6.

Prints one JSON line: for the wrapper (and, where ``pack_signals``
takes ``out=``, for the wrapper writing into a slot of a preallocated
(K, B, T, F) buffer, as ``decode_superstep`` calls it) the three times
of ``repro_torch.obs.timing.split_ms`` (CUDA events around one call,
the host's time per call enqueued without a sync, the kernel's device
time from ``torch.profiler``), the host time of the bare C entry, the
plain version's event time, and the kernel's device time at mask
densities 0 (no row read, every row stored as zeros) and 1 (every row
read).  Every device time is read after every event and host time
(``obs/timing.py`` says why).  Each output is held to the plain version
with ``torch.equal`` first::

    PYTHONPATH=src python -m repro_torch.kernels.extract_pack.timing

It reads whatever ``pack_signals`` and C entry the tree it lies in has,
so a copy of this file and of ``obs/timing.py`` into another tree's
package times that tree's kernel.
"""
from __future__ import annotations

import inspect
import json
import subprocess

import torch

from repro_torch.kernels import stream_of
from repro_torch.kernels.build import library
from repro_torch.kernels.extract_pack.ops import pack_signals
from repro_torch.kernels.extract_pack.ref import extract_pack_ref
from repro_torch.obs.timing import (Deferred, event_ms, host_ms, resolve,
                                     split_ms)

B, T, F, K = 8, 4, 12288, 8
MATCH = ("extract_pack",)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((B, T, F), generator=g, device=dev).bfloat16()
    toks = torch.randint(0, 151552, (B, T), generator=g, device=dev,
                         dtype=torch.int32)
    msk = torch.rand((B, T), generator=g, device=dev) < 0.6
    want = extract_pack_ref(feats, toks, msk)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    row = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "ops": inspect.getsourcefile(pack_signals),
           "shape": [B, T, F], "mask_true": int(msk.sum())}

    for a, w in zip(pack_signals(feats, toks, msk), want):
        assert torch.equal(a, w), "pack_signals != plain version"
    row["wrapper"] = split_ms(lambda: pack_signals(feats, toks, msk), MATCH)

    if "out" in inspect.signature(pack_signals).parameters:
        bufs = (torch.empty((K, B, T, F), dtype=feats.dtype, device=dev),
                torch.empty((K, B, T), dtype=torch.int32, device=dev),
                torch.empty((K, B), dtype=torch.int32, device=dev))
        slot = tuple(x[3] for x in bufs)
        pack_signals(feats, toks, msk, out=slot)
        for a, w in zip(slot, want):
            assert torch.equal(a, w), "pack_signals(out=) != plain version"
        row["wrapper_out"] = split_ms(
            lambda: pack_signals(feats, toks, msk, out=slot), MATCH)

    pf, pt, cnt = (torch.empty_like(x) for x in want)
    fn = library().repro_extract_pack
    args = (feats.data_ptr(), toks.data_ptr(), msk.data_ptr(), pf.data_ptr(),
            pt.data_ptr(), cnt.data_ptr(), B, T, F, feats.element_size(),
            stream_of(feats))
    assert fn(*args) == 0
    row["entry_host_ms"] = host_ms(lambda: fn(*args))
    row["plain_ms"] = event_ms(lambda: extract_pack_ref(feats, toks, msk))
    for p in (0.0, 1.0):
        m = torch.full_like(msk, bool(p))
        for a, w in zip(pack_signals(feats, toks, m),
                        extract_pack_ref(feats, toks, m)):
            assert torch.equal(a, w), f"pack_signals != plain at density {p}"
        row[f"device_ms_density_{p:g}"] = Deferred(
            lambda m=m: pack_signals(feats, toks, m), MATCH, 20)
    print(json.dumps(resolve(row)), flush=True)


if __name__ == "__main__":
    main()
