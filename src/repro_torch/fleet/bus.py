"""Draft-version bus: fan one trainer's published drafts out to N
data-parallel serving replicas (port of ``repro/fleet/bus.py``).

The bus keeps only the newest ``DraftVersion`` (deploys are cumulative: a
replica that missed seq 2 and picks up seq 3 is as current as one that
saw both), and every subscriber is itself a valid engine
``deploy_source``: calling it is a lock-free attribute read returning the
newest version, and ``ServingEngine._poll_deploy`` ignores versions at or
below its own deploy seq.  So fan-out adds nothing to the serving path:
each replica still pays one Python attribute read per superstep.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.training.service import DraftVersion


class _Subscriber:
    """One replica's view of the bus.  Callable, so it plugs straight
    into ``ServingEngine(deploy_source=...)``."""

    def __init__(self, bus: "DraftVersionBus", name: str):
        self._bus = bus
        self.name = name
        self.delivered_seq = 0   # newest seq this replica has seen
        self.deliveries = 0      # times a poll returned a new version

    def __call__(self) -> Optional[DraftVersion]:
        ver = self._bus.pull()
        if ver is not None and ver.seq > self.delivered_seq:
            self.delivered_seq = ver.seq
            self.deliveries += 1
        return ver

    poll = __call__


class DraftVersionBus:
    """Newest-wins fan-out of ``DraftVersion``s to named subscribers.

    ``source`` is an optional upstream poll (``TrainingService.poll`` or
    a ``RemoteDeploySource``) checked on every subscriber pull, so the
    bus needs no thread of its own: the replicas' own per-superstep polls
    drive it.  ``publish`` pushes a version directly."""

    def __init__(self, source: Optional[Callable[[], Optional[DraftVersion]]]
                 = None):
        self._source = source
        self._latest: Optional[DraftVersion] = None   # lock-free slot
        self.published = 0
        self.subscribers: Dict[str, _Subscriber] = {}

    def publish(self, ver: DraftVersion):
        cur = self._latest
        if cur is None or ver.seq > cur.seq:
            self._latest = ver
            self.published += 1

    def pull(self) -> Optional[DraftVersion]:
        if self._source is not None:
            ver = self._source()
            if ver is not None:
                self.publish(ver)
        return self._latest

    def subscribe(self, name: str) -> _Subscriber:
        if name in self.subscribers:
            return self.subscribers[name]
        sub = _Subscriber(self, name)
        self.subscribers[name] = sub
        return sub

    def stats(self) -> Dict:
        return {"published": self.published,
                "latest_seq": self._latest.seq if self._latest else 0,
                "subscribers": {n: {"delivered_seq": s.delivered_seq,
                                    "deliveries": s.deliveries}
                                for n, s in self.subscribers.items()}}
