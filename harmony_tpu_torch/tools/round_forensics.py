"""Round forensics: per-phase attribution report for committed rounds.

Stitches ``consensus.round`` traces (the live in-process store after a
scenario run, or JSONL span-sink files exported by real nodes) into
per-round ``RoundTimeline``s — announce_wire, verify_sched_wait,
verify_dispatch, vote_return, quorum_assembly, commit_insert — and
reports where the round time goes, naming the dominating phase.  This
is the attribution instrument the speed arc gates on: a kernel or
aggregation PR must move a *named phase*, not just the p99.

A scenario run checks its nodes' signatures on the card (without CUDA
it raises before building anything); ``--cpu`` runs them on the CPU
through the twin kernels.  Span files need no device.

Usage:
    # analyze exported span sinks (merged across nodes; clock-skew
    # aligned per node)
    python -m harmony_tpu_torch.tools.round_forensics spans_*.jsonl

    # self-driving: run a chaos scenario in-process, analyze its spans
    python -m harmony_tpu_torch.tools.round_forensics \
        --scenario wan_committee --quick

    # the gate: >= min-fraction of committed-round wall time must be
    # attributed, and the report must name a dominating phase
    python -m harmony_tpu_torch.tools.round_forensics \
        --scenario wan_committee --quick --check

Exit codes: 0 OK; 1 --check violated; 2 usage/no input.

The port's copy of the JAX package's ``tools/round_forensics.py``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from . import add_cpu_flag, device_checks


def _collect_paths(args_paths) -> list:
    out = []
    for p in args_paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "spans_*.jsonl*"))))
        else:
            out.append(p)
    return out


def _aggregate(timelines) -> dict:
    from ..obs import PHASES

    total_wall = sum(t.wall_s for t in timelines)
    phase_s = {p: 0.0 for p in PHASES}
    per_phase: dict = {p: [] for p in PHASES}
    for t in timelines:
        for p, s in t.phases.items():
            phase_s[p] += s
            per_phase[p].append(s)
    level_s: dict = {}
    for t in timelines:
        for lv, s in getattr(t, "levels", {}).items():
            level_s[lv] = level_s.get(lv, 0.0) + s
    attributed = sum(phase_s.values())
    frac = (attributed / total_wall) if total_wall > 0 else 0.0
    dominant = max(phase_s.items(), key=lambda kv: kv[1])[0] \
        if attributed > 0 else None
    quant = {}
    for p, vals in per_phase.items():
        if not vals:
            continue
        vals.sort()
        quant[p] = {
            "p50_s": round(vals[len(vals) // 2], 6),
            "p99_s": round(vals[min(len(vals) - 1,
                                    int(len(vals) * 0.99))], 6),
            "share": round(phase_s[p] / attributed, 4)
            if attributed > 0 else 0.0,
        }
    return {
        "rounds": len(timelines),
        "total_wall_s": round(total_wall, 6),
        "attributed_fraction": round(frac, 4),
        "dominant_phase": dominant,
        "phase_seconds": {p: round(s, 6) for p, s in phase_s.items()
                          if s > 0},
        "phases": quant,
        # aggregation-overlay attribution INSIDE quorum_assembly: time
        # spent merging/verifying contributions, keyed by Handel level
        # ("L1", "L2", ...) — nonempty only when the overlay ran
        "aggregation_levels": {lv: round(s, 6)
                               for lv, s in sorted(level_s.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="span-sink JSONL files (or directories of "
                         "spans_*.jsonl) exported by --span-sink-dir "
                         "nodes")
    ap.add_argument("--scenario", default=None,
                    help="run this chaos scenario in-process and "
                         "analyze its live span store")
    ap.add_argument("--quick", action="store_true",
                    help="reduced scenario durations (with --scenario)")
    ap.add_argument("--check", action="store_true",
                    help="gate: fail unless committed rounds exist, "
                         ">= --min-fraction of their wall time is "
                         "attributed, and a dominating phase is named")
    ap.add_argument("--min-fraction", type=float, default=0.95,
                    help="attribution floor for --check (default 0.95)")
    ap.add_argument("--include-abandoned", action="store_true",
                    help="report abandoned rounds too (partial "
                         "timelines; never gated)")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here (default stdout)")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)

    from .. import trace
    from ..obs import build_timelines, observe_timelines, read_spans

    if args.scenario:
        from ..chaostest import SCENARIOS, run

        if args.scenario not in SCENARIOS:
            print(f"round_forensics: unknown scenario {args.scenario}; "
                  f"known: {sorted(SCENARIOS)}", file=sys.stderr)
            return 2
        scenario = SCENARIOS[args.scenario](quick=args.quick)
        with device_checks(args.cpu):
            print(f"round_forensics: running {args.scenario} "
                  f"(window={scenario.window_s:g}s)...",
                  file=sys.stderr, flush=True)
            result = run(scenario)
        print(f"round_forensics: scenario "
              f"{'OK' if result.passed else 'VIOLATED'} "
              f"heads={result.heads}", file=sys.stderr, flush=True)
        # run() resets the store at START only: the spans are still live
        spans = trace.spans()
    elif args.paths:
        paths = _collect_paths(args.paths)
        spans = read_spans(paths)
        print(f"round_forensics: {len(spans)} spans from "
              f"{len(paths)} file(s)", file=sys.stderr)
    else:
        ap.print_usage(file=sys.stderr)
        print("round_forensics: need span-sink paths or --scenario",
              file=sys.stderr)
        return 2

    timelines = build_timelines(
        spans, committed_only=not args.include_abandoned
    )
    committed = [t for t in timelines if t.committed]
    observe_timelines(committed)  # populate harmony_round_phase_seconds

    agg = _aggregate(committed)
    report = {
        "aggregate": agg,
        "rounds": [t.to_dict() for t in timelines],
    }
    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"round_forensics: wrote {args.out}", file=sys.stderr)
    else:
        print(text)

    if agg["rounds"]:
        print(f"round_forensics: {agg['rounds']} committed round(s), "
              f"{agg['attributed_fraction'] * 100:.1f}% attributed, "
              f"dominant phase: {agg['dominant_phase']}",
              file=sys.stderr)
        if agg["aggregation_levels"]:
            lv = ", ".join(f"{k}={s:.3f}s"
                           for k, s in agg["aggregation_levels"].items())
            print(f"round_forensics: quorum_assembly overlay levels: {lv}",
                  file=sys.stderr)

    if args.check:
        if not committed:
            print("round_forensics: CHECK FAILED — no committed rounds",
                  file=sys.stderr)
            return 1
        if agg["attributed_fraction"] < args.min_fraction:
            print(f"round_forensics: CHECK FAILED — attributed "
                  f"{agg['attributed_fraction']:.3f} < "
                  f"{args.min_fraction}", file=sys.stderr)
            return 1
        if not agg["dominant_phase"]:
            print("round_forensics: CHECK FAILED — no dominating phase",
                  file=sys.stderr)
            return 1
        print("round_forensics: CHECK OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    rc = main()
    # scenario runs leave daemon threads behind (see chaos_sweep.py);
    # the verdict must not depend on interpreter shutdown luck
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
