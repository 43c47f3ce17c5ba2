"""chip_smoke.py's overload phases alone, with no profiler session before
them (about 4 minutes on one H100).

Runs chip_smoke.py's env phase (the kernel build), the ladder's overload
rungs (glm4-9b width at 2 layers: preempt-on against preempt-off,
greedy and sampled, dense and paged), the one-shot serve (the weights
and streams the later phases compare with), the overload_serve phase
and the tide phase, each printing chip_smoke.py's JSON lines.  In
chip_smoke.py the overload serves run after the five profiles, whose
residue makes every later launch cost the host more; here they run
right after the one-shot serve.

    python3 scripts/overload_smoke.py > overload.out

from the repository's root, on a machine with a CUDA card.
"""
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    cs.phase_env()
    import torch
    from repro_torch.configs import get
    from repro_torch.core import eagle
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get("glm4-9b"), num_layers=2)
    dcfg = eagle.draft_config(cfg)
    params = T.init(cfg, 1, device=torch.device("cuda"))
    dparams = eagle.draft_init(dcfg, 2, device=torch.device("cuda"))
    t0 = time.perf_counter()
    rungs = cs._overload_ladder(cfg, params, dcfg, dparams)
    cs.emit({"phase": "ladder", "layers": 2, "overload": rungs,
             "seconds": round(time.perf_counter() - t0, 1)})
    del params, dparams
    torch.cuda.empty_cache()
    _, eng, dense, dense_streams, _ = cs.phase_serve()
    t0 = time.perf_counter()
    out = cs.phase_overload_serve(eng)
    cs.emit({"phase": "overload_smoke", "overload_serve_s":
             round(time.perf_counter() - t0, 1), "launches": out})
    model = (eng.cfg, eng.params, eng.dcfg, eng.dparams)
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cs.phase_tide(*model, dense, dense_streams)
    cs.emit({"phase": "overload_smoke_done",
             "tide_s": round(time.perf_counter() - t0, 1)})


if __name__ == "__main__":
    main()
