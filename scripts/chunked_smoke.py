"""chip_smoke.py's chunked refill prefill phases alone, with no profiler
session before them (about 3 minutes on one H100).

Runs chip_smoke.py's env phase (the kernel build), the card tests of the
verify kernel (``-k "chunk_shape or verify_vs_plain or pad_shift"``), the
kernels phase in its child process (the verify row's chunk case at T =
128 is printed again apart), the ladder (its chunked rungs included),
the one-shot serve and the chunked_serve phase, each printing
chip_smoke.py's JSON lines.  In chip_smoke.py the chunked serves run
after the five profiles, whose residue makes every later launch cost
the host more; here they run right after the one-shot serve, so their
tokens/s and superstep ms compare with its directly.

    python3 scripts/chunked_smoke.py > chunked.out

from the repository's root, on a machine with a CUDA card.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    cs.phase_env()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "gpu",
         "tests/test_torch_kernels.py", "-k",
         "chunk_shape or verify_vs_plain or pad_shift"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"),
        capture_output=True, text=True)
    print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    if r.returncode:
        sys.exit(r.returncode)
    rows = cs.phase_kernels_apart()
    verify = next(x for x in rows if x["name"] == "verify_attention")
    print({"chunk_case": [c for c in verify["cases"]
                          if c.get("chunk_case")]}, flush=True)
    cs.phase_ladder()
    _, eng, dense, dense_streams, _ = cs.phase_serve()
    out = cs.phase_chunked_serve(eng, dense, dense_streams)
    cs.emit({"phase": "chunked_smoke_done", "launches": out})


if __name__ == "__main__":
    main()
