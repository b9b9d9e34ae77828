"""The port's operator tools: the scripts that drive and gate the node.

Each runs as ``python -m harmony_tpu_torch.tools.<name>`` and keeps the
JAX package's tool's ``main(argv)``, flags, output lines and checks:

    obs_smoke              one traced round; /metrics and /debug/trace
    sched_smoke            FBFT rounds, replay and an ingress flood
                           through the one scheduler
    compile_surface_smoke  no first use after warmup across a
                           committee-width change
    loadgen                paced three-lane traffic, latency under load
    soak                   resource stationarity over a window
    crash_sweep            a block commit killed at every crash point
    chaos_sweep            the chaos scenarios and their invariants
    round_forensics        committed rounds split by phase
    localnet               a bootnode and N node processes

and ``check.sh`` runs them as the port's gate.  A tool that builds nodes
or checks signatures runs those checks on the card: it resolves CUDA
before it builds anything and raises ``RuntimeError`` without it.
``--cpu`` runs them on the CPU through the twins (``ops/twin.py``), as
the tests do.  Nothing here sets an environment variable at import.
"""

from __future__ import annotations

import contextlib
import os


def add_cpu_flag(ap) -> None:
    ap.add_argument("--cpu", action="store_true",
                    help="run the node's checks on the CPU through the "
                         "twin kernels instead of on the card")


@contextlib.contextmanager
def device_checks(cpu: bool):
    """The node's checks forced onto the device path for the length of
    the block: on the card, which must exist (``RuntimeError`` without
    CUDA, before anything is built), or with ``cpu`` on the CPU through
    the twins (``HARMONY_KERNEL_TWIN=1``, which answers off the card
    only).  Yields the device; the path goes back to AUTO and the
    variable to what it was after the block."""
    from .. import device as DV

    prev = os.environ.get("HARMONY_KERNEL_TWIN")
    if cpu:
        os.environ["HARMONY_KERNEL_TWIN"] = "1"
        DV.use_device(True, device="cpu")
    else:
        DV.use_device(True)
    try:
        card_or_raise(cpu)
        yield DV.resolve_device()
    finally:
        DV.use_device(None)
        if prev is None:
            os.environ.pop("HARMONY_KERNEL_TWIN", None)
        else:
            os.environ["HARMONY_KERNEL_TWIN"] = prev


def card_or_raise(cpu: bool) -> None:
    """Without ``cpu``, raise ``RuntimeError`` unless CUDA is there."""
    if cpu:
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --cpu to run on the CPU")
