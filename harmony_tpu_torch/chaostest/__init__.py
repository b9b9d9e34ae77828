"""Adversarial scenario framework: composed chaos at mainnet shape.

Public surface:

* :mod:`.scenario` — the declarative vocabulary (Topology, Traffic,
  Phase, Invariants, Scenario);
* :mod:`.scenarios` — the named scenarios (composed fault
  scenarios, durable kill/restart, byzantine adversaries, overload
  survival, WAN/gray-failure netem) + ``SCENARIOS`` registry;
* :mod:`.runner` — ``run(scenario) -> ScenarioResult``;
* :mod:`.netem` — seed-deterministic per-directed-link conditioning
  (latency/jitter/loss/dup/reorder/bandwidth) for both transports;
* :mod:`.fixtures` — deterministic fixtures shared with the unit
  tiers (election fixtures, flood shapes, the mainnet roster).

The scenario × fault × invariant matrix is documented in
docs/ANALYSIS.md.  ``chip_smoke.py``'s chaos phase runs three of the
scenarios on the card with the real kernels; the CPU tests run them on
the twins.

The port's copy of the JAX package's ``chaostest/__init__.py``.
"""

from .runner import RunEnv, ScenarioResult, run
from .scenario import Invariants, Kill, Phase, Scenario, Topology, Traffic
from .scenarios import SCENARIOS

__all__ = [
    "Invariants",
    "Kill",
    "Phase",
    "RunEnv",
    "Scenario",
    "ScenarioResult",
    "SCENARIOS",
    "Topology",
    "Traffic",
    "run",
]
