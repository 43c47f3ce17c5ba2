"""One kernel call timed three ways on the card.

* ``event_ms``: the median of CUDA events around single calls.  On an
  idle queue an event pair brackets the wrapper's host work too, so for
  a kernel of a few microseconds it reads the host, not the kernel.
* ``host_ms``: the host's time per call, calls enqueued back to back
  without a sync (the queue never fills, so no call waits on the card).
* ``device_ms``: the matched kernels' own device time per call, read by
  ``torch.profiler`` over back-to-back calls.

Read the profiler last.  After a ``torch.profiler`` session the process
pays more host time for every kernel launch, so an event or host time
read after it is not the call's; ``python -m repro_torch.obs.timing``
prints the host's time per small launch before and after one session
(PERF.md gives its reading).  ``split_ms`` therefore reads the events
and the host time at once and leaves the device time as a ``Deferred``,
which ``resolve`` reads once every other number has been taken.  Every
function needs a CUDA card; nothing here runs on the CPU.
"""
from __future__ import annotations

import json
import statistics
import time

import torch


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn`` by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def host_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """The host's ms per call of ``fn``: the median over ``repeats``
    batches of ``iters`` calls enqueued back to back, each batch after a
    sync."""
    fn()
    per_call = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per_call.append((time.perf_counter() - t0) * 1e3 / iters)
    torch.cuda.synchronize()
    return statistics.median(per_call)


PROFILE_ATTEMPTS = 3


def device_ms(fn, match, iters: int = 20) -> float:
    """Device ms per call of ``fn`` of the CUDA kernels whose name holds
    one of the strings of ``match``, by ``torch.profiler`` over ``iters``
    calls.  A session whose matched launches are not a whole multiple
    of ``iters`` (now and then one sees none of them, after many
    sessions in a process) is read again, up to ``PROFILE_ATTEMPTS``
    sessions, each retry counted in ``device_ms.retries``; raises when
    none sees them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:
            device_ms.retries += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, seen = 0.0, 0
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and any(m in e.key for m in match)):
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
                seen += e.count
        if seen and seen % iters == 0:
            return us / iters / 1e3
    raise RuntimeError(f"the profiler saw {seen} launches of kernels "
                       f"matching {match} in {iters} calls, "
                       f"{PROFILE_ATTEMPTS} times")


device_ms.retries = 0


def launch_grids(fn, match, iters: int = 1) -> list:
    """The grid ``[x, y, z]`` of every launch of a CUDA kernel whose name
    holds one of the strings of ``match`` in ``iters`` calls of ``fn``, in
    launch order, as ``torch.profiler``'s trace records it (the grid the
    card ran, not the one the caller meant).  A session that sees none
    is read again, as ``device_ms`` does; raises when none sees them."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:
            device_ms.retries += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        grids = [e["args"]["grid"] for e in events
                 if e.get("cat") == "kernel"
                 and any(m in e.get("name", "") for m in match)]
        if grids:
            return grids
    raise RuntimeError(f"the profiler's trace holds no launch of kernels "
                       f"matching {match} in {iters} calls, "
                       f"{PROFILE_ATTEMPTS} times")


class Deferred:
    """A profiler reading of ``fn`` still to be taken by ``resolve``: its
    ``device_ms`` or, with ``read=launch_grids``, its launches' grids."""

    def __init__(self, fn, match, iters: int, read=None):
        self.fn, self.match, self.iters, self.read = fn, match, iters, read


def split_ms(fn, match, iters: int = 20) -> dict:
    """``ms`` (events) and ``host_ms`` of one call of ``fn`` now, and its
    ``device_ms`` as a ``Deferred`` for ``resolve``."""
    return {"ms": event_ms(fn, iters), "host_ms": host_ms(fn, iters),
            "device_ms": Deferred(fn, match, iters)}


def resolve(obj, _read=None):
    """``obj`` with every ``Deferred`` in its dicts and lists replaced by
    its reading, each taken once."""
    read = {} if _read is None else _read
    if isinstance(obj, Deferred):
        if id(obj) not in read:
            read[id(obj)] = (obj.read or device_ms)(obj.fn, obj.match,
                                                    obj.iters)
        return read[id(obj)]
    if isinstance(obj, dict):
        return {k: resolve(v, read) for k, v in obj.items()}
    if isinstance(obj, list):
        return [resolve(v, read) for v in obj]
    return obj


def launch_host_us(iters: int = 20000) -> float:
    """The host's us per launch of a small in-place add, ``iters``
    enqueued without a sync."""
    x = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        x.add_(1.0)
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def main():
    """Print the host's us per small launch, three readings before and
    three after one ``torch.profiler`` session, as one JSON line."""
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    before = [launch_host_us() for _ in range(3)]
    x = torch.zeros(1024, device="cuda")
    device_ms(lambda: x.add_(1.0), ("elementwise",))
    after = [launch_host_us() for _ in range(3)]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "launch_host_us_before_profiler": before,
                      "launch_host_us_after_profiler": after}), flush=True)


if __name__ == "__main__":
    main()
