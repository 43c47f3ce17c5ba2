"""chip_smoke.py's fleet phase, with what it compares against, and the
profile's cost at three depths (about 7 minutes on one H100).

Runs chip_smoke.py's env phase (the kernel build), the one-shot serve
(the weights and streams the later phases compare with), the profile of
the dense engine at 9 new tokens a request (a superstep of 8 decoding
rounds), at 5 (4 rounds) and at 3 (2), each line with its seconds, then
the tide, tide_async and fleet phases, each printing chip_smoke.py's
JSON lines.  Then the fleet's remote async run twice more, with the
serving side's signal sender waking every 1 s when idle and then every
0.01 s (``RemoteTrainingService(poll_s=)``, JAX's default 0.01): whether
the sender's idle wake-ups slow the serving thread's supersteps.

    python3 scripts/fleet_smoke.py > fleet.out

from the repository's root, on a machine with a CUDA card.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    cs.phase_env()
    import torch
    _, eng, dense, dense_streams, _ = cs.phase_serve()
    for new in (9, 5, 3):
        cs.PROFILE_NEW = new
        cs.phase_profile(eng, f"dense, {new} new tokens")
    model = (eng.cfg, eng.params, eng.dcfg, eng.dparams)
    del eng
    torch.cuda.empty_cache()
    tide_row = cs.phase_tide(*model, dense, dense_streams)
    async_row = cs.phase_tide_async(*model, dense, dense_streams, tide_row)
    t0 = time.perf_counter()
    cs.phase_fleet(*model, dense_streams, tide_row, async_row)
    fleet_s = round(time.perf_counter() - t0, 1)
    from repro_torch.fleet.remote import RemoteTrainingService
    defaults = RemoteTrainingService.__init__.__kwdefaults__
    for poll_s in (1.0, 0.01):
        defaults["poll_s"] = poll_s
        cs.emit({"phase": "fleet_variant", "sender_poll_s": poll_s})
        cs._fleet_remote_async(*model[:2], model[3], dense_streams,
                               async_row=async_row)
        torch.cuda.empty_cache()
    cs.emit({"phase": "fleet_smoke_done", "profile_s": cs.PROFILE_S,
             "fleet_s": fleet_s})


if __name__ == "__main__":
    main()
