"""Disaggregated serving: an out-of-process trainer and a fleet of engine
replicas (port of ``repro/fleet/``).

The paper maps the decoupled serving and training engines onto
different devices: one draft trainer, updated continuously, amortized
over N data-parallel serving replicas.  This package is that shape:

- ``wire``         the length-prefixed, versioned, CRC-checked frame
                   codec carrying ``SignalBatch`` windows (the schema of
                   ``SignalStore.spill``'s .npz shards) and
                   ``DraftVersion`` payloads, as numpy arrays;
- ``remote``       ``RemoteSignalChannel`` / ``RemoteTrainingService``:
                   the serving-side endpoint, with the engine's
                   ``SignalChannel`` and ``deploy_source`` interfaces
                   (no serving-path sync, drop-oldest backpressure over
                   the socket);
- ``trainer_main`` the trainer's process (``python -m
                   repro_torch.fleet.trainer_main``), running the port's
                   ``TrainingService`` with its own interpreter and, on
                   a card, its own CUDA context;
- ``bus``          draft-version fan-out to N replica subscribers;
- ``router``       the request router and ``ServingFleet``, N
                   data-parallel ``ServingEngine`` replicas fed by one
                   trainer.

``FleetConfig`` lives here, so ``core.tide`` can accept
``TideConfig(fleet=...)`` without importing sockets or subprocesses until
a fleet is asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class FleetConfig:
    """Disaggregation knobs (CLI: ``--fleet-replicas``,
    ``--trainer-endpoint``, ``--fleet-route``).

    ``replicas=0`` (the default) means no fleet: one engine and an
    in-process trainer; ``trainer_endpoint`` alone moves training out of
    process for one engine.  ``trainer_endpoint`` takes ``spawn`` (start
    a trainer process on a private unix socket), ``unix:/path`` or
    ``tcp:host:port`` (connect to a running
    ``repro_torch.fleet.trainer_main``)."""
    replicas: int = 0
    trainer_endpoint: Optional[str] = None
    route: str = "least"     # "least" (least-loaded) | "rr" (round-robin)

    def __post_init__(self):
        if self.replicas < 0:
            raise ValueError(f"fleet replicas must be >= 0, "
                             f"got {self.replicas}")
        if self.route not in ("least", "rr"):
            raise ValueError(f"unknown fleet route {self.route!r} "
                             "(expected 'least' or 'rr')")

    @property
    def enabled(self) -> bool:
        return self.replicas > 0 or self.trainer_endpoint is not None
