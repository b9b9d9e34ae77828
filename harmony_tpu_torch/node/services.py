"""Service manager: typed service lifecycle.

The role of the reference's api/service manager (reference:
api/service/manager.go:12-57 typed service registry, :102-150
StartServices/StopServices in registration order / reverse order).

The port's copy of the JAX package's ``node/services.py``.
"""

from __future__ import annotations

from enum import IntEnum

from ..log import get_logger

_log = get_logger("services")


class ServiceType(IntEnum):
    """reference: api/service/manager.go:57-63 service type ids."""

    CLIENT_SUPPORT = 0
    SUPPORT_EXPLORER = 1
    CONSENSUS = 2
    BLOCK_PROPOSAL = 3
    NETWORK_INFO = 4
    PROMETHEUS = 5
    SYNCHRONIZE = 6
    CROSSLINK_SENDING = 7
    PPROF = 8
    ROSETTA = 9    # this framework's ids; the reference serves rosetta
    WEBSOCKET = 10  # and WS from its RPC stack, not service slots
    MAINTENANCE = 11  # resource governor sampler + health watchdog
    SPAN_SINK = 12  # durable span export (obs.SpanSink JSONL writer)


class Service:
    """Interface: Start()/Stop() idempotent, raising on hard failure."""

    def start(self):
        raise NotImplementedError

    def stop(self):
        raise NotImplementedError


class Manager:
    def __init__(self):
        self._services: list[tuple[ServiceType, Service]] = []
        self._running = False

    def register(self, stype: ServiceType, service: Service):
        if any(t == stype for t, _ in self._services):
            raise ValueError(f"service {stype.name} already registered")
        self._services.append((stype, service))

    def get(self, stype: ServiceType) -> Service | None:
        for t, s in self._services:
            if t == stype:
                return s
        return None

    def start_services(self):
        """Start in registration order; on failure, stop what started
        (reference: manager.go:102-126)."""
        started = []
        try:
            for stype, svc in self._services:
                svc.start()
                started.append(svc)
            self._running = True
        except Exception:
            for svc in reversed(started):
                try:
                    svc.stop()
                except Exception as e:
                    # rollback must reach every started service, and
                    # stop_fn callbacks can raise anything: log, keep
                    # rolling back, re-raise the original start failure
                    _log.warn("service stop failed during rollback",
                              service=type(svc).__name__, error=str(e))
            raise

    def stop_services(self):
        """Reverse order (reference: manager.go:128-150)."""
        for _, svc in reversed(self._services):
            try:
                svc.stop()
            except Exception as e:
                # shutdown must reach every service, and stop_fn
                # callbacks can raise anything: log and move on
                _log.warn("service stop failed during shutdown",
                          service=type(svc).__name__, error=str(e))
        self._running = False

    @property
    def running(self) -> bool:
        return self._running
