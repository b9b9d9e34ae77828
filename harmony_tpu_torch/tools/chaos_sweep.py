"""Adversarial scenario sweep: run the named chaos scenarios and
gate on their liveness invariants.

Each scenario (harmony_tpu_torch/chaostest/scenarios.py) composes a
topology, a traffic profile and a seed-deterministic fault script,
then asserts machine-checked invariants: liveness (the chain advances
>= N blocks inside the window), ZERO consensus-lane sheds, a round-p99
bound, no divergent heads, plus scenario-specific checks (committee
rotated, cross-shard value arrived).  Any violation produces exactly
one correlated flight-recorder dump (trace.anomaly's (kind, trace_id)
dedup) and fails ``--check``.

Every reported number is tagged ``source: measured`` and named
``chaos_<scenario>_<metric>``.  ``--bench-out`` writes, and
``--bench-base`` reads, only the file the caller names.

The nodes' checks run on the card (the runner's real kernels); without
CUDA the sweep raises before it builds anything.  ``--cpu`` runs them
on the CPU through the twin kernels.

Usage:
    python -m harmony_tpu_torch.tools.chaos_sweep                # full
    python -m harmony_tpu_torch.tools.chaos_sweep --quick --check
    python -m harmony_tpu_torch.tools.chaos_sweep \
        --scenario view_change_storm --quick
    python -m harmony_tpu_torch.tools.chaos_sweep --quick \
        --bench-out OUT.json --bench-round 6 [--bench-base PRIOR.json]

The port's copy of the JAX package's ``tools/chaos_sweep.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import add_cpu_flag, device_checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", action="append", default=None,
                    help="run only this scenario (repeatable); default "
                         "every scenario")
    ap.add_argument("--only", default=None, metavar="SUBSTR",
                    help="filter the scenario list (exact name or "
                         "case-insensitive substring) — composes with "
                         "--scenario")
    ap.add_argument("--seed", type=int, default=None,
                    help="override every selected scenario's baked-in "
                         "seed (keys, fixtures, netem draws and garble "
                         "bytes all re-derive from it)")
    ap.add_argument("--quick", action="store_true",
                    help="reduced durations/targets (the CI stage "
                         "budget); same topology, faults, invariants")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any scenario violates an invariant")
    ap.add_argument("--bench-out", default=None,
                    help="write a BENCH round file carrying the "
                         "scenario metrics (ledger schema)")
    ap.add_argument("--bench-round", type=int, default=6,
                    help="round number stamped into --bench-out")
    ap.add_argument("--bench-base", default=None,
                    help="existing bench JSON (bench.py line or BENCH "
                         "round file) whose metrics ride alongside in "
                         "--bench-out")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)

    from ..chaostest import SCENARIOS, run

    names = args.scenario or list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"chaos_sweep: unknown scenario(s) {unknown}; "
              f"known: {sorted(SCENARIOS)}", file=sys.stderr)
        return 2
    if args.only is not None:
        needle = args.only.lower()
        names = [
            n for n in names
            if n == args.only or needle in n.lower()
        ]
        if not names:
            print(f"chaos_sweep: --only {args.only!r} matches no "
                  f"scenario; known: {sorted(SCENARIOS)}",
                  file=sys.stderr)
            return 2
    results = []
    with device_checks(args.cpu):
        for name in names:
            scenario = SCENARIOS[name](quick=args.quick)
            if args.seed is not None:
                import dataclasses

                scenario = dataclasses.replace(scenario, seed=args.seed)
            print(f"chaos_sweep: running {name} "
                  f"(seed={scenario.seed}, window={scenario.window_s:g}s, "
                  f"{len(scenario.phases)} fault phase(s))...",
                  file=sys.stderr, flush=True)
            try:
                r = run(scenario)
            except Exception as e:  # noqa: BLE001 — one scenario crashing
                # (build failure on a loaded box) must surface as ITS
                # violation, not kill the rest of the sweep
                from ..chaostest import ScenarioResult

                r = ScenarioResult(
                    name=name, passed=False,
                    violations=[{"invariant": "run_crashed",
                                 "detail": repr(e)}],
                    metrics={}, violation_dumps=[], all_dumps=[], heads={},
                )
            results.append(r)
            status = "OK" if r.passed else "VIOLATED"
            print(f"chaos_sweep: {name}: {status} heads={r.heads} "
                  + " ".join(
                      f"{k}={v['value']}" for k, v in r.metrics.items()
                  ), file=sys.stderr, flush=True)
            for v in r.violations:
                print(f"chaos_sweep:   {name}.{v['invariant']}: "
                      f"{v['detail']} (dump: {v.get('dump')})",
                      file=sys.stderr, flush=True)

    extra = {}
    for r in results:
        for metric, entry in r.metrics.items():
            if entry.get("value") is None:
                continue
            e = dict(entry)
            e["scenario"] = r.name
            e["quick"] = args.quick
            extra[f"chaos_{r.name}_{metric}"] = e
    passed = sum(1 for r in results if r.passed)
    extra["chaos_scenarios_passed"] = {
        "value": passed, "unit": "scenarios", "source": "measured",
        "total": len(results), "quick": args.quick,
    }
    doc = {
        "metric": "chaos_scenarios_passed",
        "value": passed,
        "unit": "scenarios",
        "source": "measured",
        "extra": extra,
        "meta": {
            "quick": args.quick,
            "scenarios": [r.name for r in results],
            "violations": [
                {"scenario": r.name, **v}
                for r in results for v in r.violations
            ],
            "violation_dumps": [
                p for r in results for p in r.violation_dumps
            ],
        },
    }
    print(json.dumps(doc), flush=True)

    if args.bench_out:
        parsed = doc
        if args.bench_base:
            with open(args.bench_base) as f:
                base = json.load(f)
            base_parsed = base.get("parsed", base)
            merged = dict(base_parsed)
            merged.setdefault("extra", {})
            merged["extra"] = dict(merged["extra"])
            merged["extra"].update(extra)
            parsed = merged
        with open(args.bench_out, "w") as f:
            json.dump({
                "n": args.bench_round,
                "cmd": "python -m harmony_tpu_torch.tools.chaos_sweep"
                       + (" --quick" if args.quick else ""),
                "parsed": parsed,
            }, f, indent=2)
            f.write("\n")
        print(f"chaos_sweep: wrote {args.bench_out} "
              f"(round {args.bench_round})", file=sys.stderr)

    if args.check and passed != len(results):
        return 1
    return 0


if __name__ == "__main__":
    rc = main()
    # hard exit: the scenarios leave daemon pump/scheduler threads and
    # native-library state behind, and CPython teardown racing them
    # can abort (SIGABRT) AFTER the verdict is decided — the CI gate's
    # exit code must be the sweep's verdict, not the interpreter's
    # shutdown luck
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
