#!/usr/bin/env bash
# The port's gate: the operator tools of harmony_tpu_torch/tools/ and the
# port's tests, stage by stage, fail-fast.
#
# The JAX package's tools/check.sh without its first stage (graftlint,
# that package's static analysis of its jnp and Pallas code, and its
# compile manifest) and without its bench-ledger comparisons:
#   2. tier-1 subset (imports, device path, warmup), then
#      compile_surface_smoke: every manifest program warm, a committee
#      width change 5 -> 12 (bucket 8 -> 16), zero first uses after it.
#   3. resilience primitives (breaker, retries, fault injection).
#   4. observability: the tracer tier, then obs_smoke (/metrics grammar,
#      /debug/trace schema of one traced round).
#   5. scheduler: its tier, then sched_smoke (fill ratio above its floor,
#      zero consensus-lane sheds under rounds + replay + ingress).
#   6. load: loadgen --duration 5 --check (rate floor, every lane active,
#      zero consensus sheds, 0 < p50 <= p99 from the tracer's spans).
#   7. chaos sweep: the chaostest tier, then five composed scenarios (the
#      two that flap the device's dispatch on the CPU, see below).
#   8. crash consistency: KV replay parity and chain recovery, then
#      crash_sweep --check (every kv.commit crash point and truncation
#      offset, native parity) and the two restart scenarios.
#   9. byzantine: slashing, ingress and adversary tiers, three byz_*
#      scenarios.
#  10. overload: governor tier, soak --quick --check (stationarity
#      slopes), overload_storm and wedged_thread_recovery.
#  11. WAN netem: the netem tier and four netem scenarios.
#  12. mainnet rehearsal: snapshot and recovery tiers, mainnet_rehearsal.
#  13. round forensics: the obs tier, then round_forensics --check over a
#      wan_committee --quick run.
#  14. vote aggregation: the overlay tier, wan_committee_200 and
#      gray_aggregator.
#
# The tools check signatures on the card (they raise without CUDA);
# --cpu runs them on the CPU through the twin kernels.  The tests hold
# the port against the JAX package, so they need it and JAX (on the CPU);
# --no-tests runs the tools alone, as on a machine without them.
#
# Usage: harmony_tpu_torch/tools/check.sh [--cpu] [--no-tests]
set -euo pipefail
cd "$(dirname "$0")/../.."

CPU=""
TESTS=1
for arg in "$@"; do
  case "$arg" in
    --cpu) CPU="--cpu" ;;
    --no-tests) TESTS=0 ;;
    *) echo "usage: $0 [--cpu] [--no-tests]" >&2; exit 2 ;;
  esac
done

tests() {
  if [ "$TESTS" = 1 ]; then
    JAX_PLATFORMS=cpu python -m pytest -q -m 'not slow' \
      -p no:cacheprovider "$@"
  fi
}

tool() {
  local name="$1"
  shift
  python -m "harmony_tpu_torch.tools.$name" "$@"
}

sweep() {
  tool chaos_sweep --quick --check $CPU "$@" > /dev/null
}

echo "== tier-1 subset, then zero first uses after warmup across a width change =="
tests tests/test_torch_imports.py tests/test_torch_device_node.py \
  tests/test_torch_aot.py tests/test_torch_tools_smokes.py
tool compile_surface_smoke $CPU

echo "== resilience: breaker, retries, fault injection =="
tests tests/test_torch_support.py

echo "== observability: tracer tier + /metrics + /debug/trace =="
tests tests/test_torch_metrics_server.py
tool obs_smoke $CPU

echo "== scheduler: continuous-batching tier + mixed-lane localnet =="
tests tests/test_torch_sched.py
tool sched_smoke $CPU

echo "== load: three paced lanes, their floors =="
tests tests/test_torch_tools_loadgen.py
tool loadgen --duration 5 --check $CPU > /dev/null

echo "== chaos sweep: composed adversarial scenarios =="
tests tests/test_torch_chaostest.py tests/test_torch_tools_chaos_sweep.py
sweep --scenario view_change_storm --scenario cross_shard_partition \
  --scenario sidecar_flap
# epoch_election_rotation and validator_churn raise at device.dispatch and
# require the host to answer for the device (the reference's fallback).
# On the card the port never answers on the host: the check raises
# DeviceError (device.py), so these two run on the CPU in either mode.
tool chaos_sweep --quick --check --cpu --scenario epoch_election_rotation \
  --scenario validator_churn > /dev/null

echo "== crash consistency: kv replay parity + crash-point sweep + restart scenarios =="
tests tests/test_torch_kv_native.py tests/test_torch_crash_recovery.py \
  tests/test_torch_tools_crash_sweep.py
tool crash_sweep --check > /dev/null
sweep --scenario leader_kill_restart --scenario rolling_restart

echo "== byzantine sweep: active adversaries + slashing pipeline =="
tests tests/test_torch_byzantine.py tests/test_torch_ingress_slash.py
sweep --scenario byz_equivocating_leader \
  --scenario byz_double_voter_slashed \
  --scenario byz_invalid_proposal_flood

echo "== overload survival: governor tier + soak + overload scenarios =="
tests tests/test_torch_governor.py tests/test_torch_tools_soak.py
tool soak --quick --check $CPU > /dev/null
sweep --scenario overload_storm --scenario wedged_thread_recovery

echo "== WAN netem: gray-failure tier + mainnet-shape committee =="
tests tests/test_torch_chaos_netem.py
sweep --scenario gray_leader --scenario asymmetric_partition \
  --scenario minority_partition_heal --scenario wan_committee

echo "== mainnet rehearsal: snapshot tiers + every axis composed =="
tests tests/test_torch_snapshot.py tests/test_torch_crash_recovery.py
sweep --only mainnet_rehearsal

echo "== round forensics: phase attribution =="
tests tests/test_torch_obs.py tests/test_torch_tools_round_forensics.py
tool round_forensics --scenario wan_committee --quick --check \
  $CPU > /dev/null

echo "== vote aggregation: overlay tier + 200-slot WAN committee =="
tests tests/test_torch_node_aggregation.py
sweep --scenario wan_committee_200 --scenario gray_aggregator

echo "check.sh: OK"
