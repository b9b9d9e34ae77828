"""Webhooks: operator alerting on consensus incidents.

The role of the reference's webhooks package (reference:
webhooks/yaml.go — a yaml-configured double-sign report hook, called
from the Registry's webHooks when checkDoubleSign trips —
consensus/double_sign.go:16-135).  Hooks are plain callables here
(HTTP POST delivery is one such callable); the node fires them from
the double-sign detector and on view changes.

The port's copy of the JAX package's ``webhooks.py``.
"""

from __future__ import annotations

import itertools
import json
import threading
import urllib.request
from collections import deque

from . import faultinject as FI
from .log import get_logger
from .resilience import RetryPolicy

_log = get_logger("webhooks")

# shared POST retry: 3 attempts, exponential backoff, deterministic
# jitter — an operator endpoint that hiccups for a second still gets
# its double-sign report; one that stays down costs three bounded
# attempts and a logged drop, never a hung thread pile-up
_POST_RETRY = RetryPolicy(attempts=3, base_delay_s=0.1, max_delay_s=1.0)

# unique watchdog participant per delivery: concurrent POSTs must not
# evict each other's registration (register() replaces same names — a
# wedged OLDER delivery would go silently unmonitored); closed handles
# deregister, and the registry's cardinality bound evicts leaks
_SENDER_SEQ = itertools.count(1)


class Hooks:
    """Named event -> list of callables(payload dict)."""

    EVENTS = ("double_sign", "view_change", "block_committed")

    def __init__(self, log_size: int = 256):
        self._hooks: dict[str, list] = {e: [] for e in self.EVENTS}
        # bounded recent-event log for tests/ops (a hot event stream
        # must not grow node memory without bound)
        self.fired: deque = deque(maxlen=log_size)

    def register(self, event: str, fn):
        if event not in self._hooks:
            raise ValueError(f"unknown webhook event {event!r}")
        self._hooks[event].append(fn)

    def fire(self, event: str, payload: dict):
        """Never raises: a broken hook must not break consensus."""
        self.fired.append((event, payload))
        for fn in self._hooks.get(event, ()):
            try:
                fn(payload)
            except Exception as e:  # any hook bug: log, never propagate
                _log.warn("webhook hook raised", event=event,
                          hook=getattr(fn, "__name__", repr(fn)),
                          error=str(e))


def http_post_hook(url: str, timeout: float = 5.0,
                   retry: RetryPolicy | None = None):
    """A hook that POSTs the payload as JSON (fire-and-forget thread —
    the reference's report hook is likewise non-blocking).  Each
    delivery makes up to ``retry.attempts`` bounded attempts with
    backoff; the final failure is a logged drop, exactly as before —
    an unreachable operator endpoint must never back-pressure
    consensus."""
    policy = retry or _POST_RETRY

    def hook(payload: dict):
        def send():
            from . import health

            # delivery threads are short-lived but BOUNDED: register
            # with the watchdog for their worst-case budget (attempts x
            # (timeout + backoff)) so a POST wedged past it — a sink
            # that accepts the connection and never answers — surfaces
            # instead of silently pinning threads
            budget = policy.attempts * (timeout + policy.max_delay_s) + 5
            # the request is built BEFORE the heartbeat registers: a
            # payload json.dumps can raise (bytes in evidence fields),
            # and raising between register and the try/finally below
            # would leak a permanently-dead participant per delivery
            try:
                req = urllib.request.Request(
                    url,
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"},
                )
            except (TypeError, ValueError) as e:
                _log.warn("webhook payload not serializable",
                          url=url, error=str(e))
                return
            hb = health.register(
                f"webhook.sender#{next(_SENDER_SEQ)}", max_age_s=budget,
                thread=threading.current_thread(),
            )

            def attempt():
                hb.beat()
                FI.fire("webhook.post")
                urllib.request.urlopen(req, timeout=timeout).close()

            try:
                policy.run(attempt, retry_on=(OSError,), key=url)
            except OSError as e:
                _log.warn("webhook POST dropped after retries",
                          url=url, error=str(e),
                          attempts=policy.attempts)
            finally:
                hb.close()

        threading.Thread(target=send, daemon=True).start()

    return hook
