"""The final-exponentiation kernel's program and plans, on the CPU.

``harmony_tpu_torch/csrc/final_exp.cuh`` holds the program that
``final_exp.cu`` runs on the card, one block per lane: the inverse of the
easy part, the Frobenius maps, the Fp12 product of ``fp12_plans.cuh``
and runs of the cyclotomic squaring of ``cyclo.cuh``, each a plan of
phases (``phases.cuh``), and the moves between the lane's values.
Outside nvcc it is plain C++, so here g++ compiles it through the plans'
runner of tests/test_torch_fp12_host.py, with the header the kernel build
generates, and ctypes loads the result: each phase's tasks run forward,
in reverse, and isolated (every task sees the scratch area as the phase
found it; two tasks writing one word fail), on a scratch area poisoned
with non-canonical words, and every product is the split product with its
threads run step by step.

The results must equal the port's plain versions bit for bit, tolerance
0 (exact integer work with unique canonical limbs):
``ops/pairing.py`` ``final_exponentiation_reference`` for the whole
program, on seeded random Fp12 values (outside the cyclotomic subgroup,
as a pad lane's Miller value is), a zero lane, one, and the Miller value
of a real pair, which must also give the JAX package's bigint pairing
(``harmony_tpu.ref.pairing``, the cubed pairing); and ``ops/towers.py``
``fp12_inv``, ``fp12_conj``, ``fp12_frobenius``, ``fp12_mul_reference``
and ``fp12_sqr_reference`` for the steps alone.  Without g++ the tests
skip.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from harmony_tpu.ref import curve as RC
from harmony_tpu.ref import pairing as RP
from harmony_tpu_torch.kernels import _build
from harmony_tpu_torch.ops import interop as TI
from harmony_tpu_torch.ops import pairing as TPR
from harmony_tpu_torch.ops import schedule as S
from harmony_tpu_torch.ops import towers as TT
from test_torch_fp12_host import HOST_RUNNER

_HOST_SRC = HOST_RUNNER + r"""
#include "final_exp.cuh"

namespace {

using host::load;
using host::store;
constexpr int kLimbs = fp384::kLimbs;
constexpr int kLane = fp12::kElems * kLimbs;

void load12(const int32_t* src, std::vector<uint32_t>& s, int at) {
  for (int e = 0; e < fp12::kElems; ++e) {
    load(src + e * kLimbs, s.data(), at + e);
  }
}

void store12(const std::vector<uint32_t>& s, int at, int32_t* dst) {
  for (int e = 0; e < fp12::kElems; ++e) {
    store(s.data(), at + e, dst + e * kLimbs);
  }
}

}  // namespace

// The program's steps into steps (at most n); returns their count, the
// last step kEnd included.
extern "C" int host_final_exp_program(int32_t* steps, int n) {
  int i = 0;
  for (;; ++i) {
    const int step = final_exp::step_at(i);
    if (i < n) steps[i] = step;
    if ((step & 0xff) == final_exp::kEnd) return i + 1;
  }
}

// The table of phases into entries (at most n); returns their count, the
// end included.
extern "C" int host_final_exp_phases(int32_t* entries, int n) {
  int i = 0;
  for (;; ++i) {
    const int e = final_exp::phase_at(i);
    if (i < n) entries[i] = e;
    if ((e & 0xff) == final_exp::kEndPhase) return i + 1;
  }
}

// The whole final exponentiation, lane by lane, as the kernel runs it:
// the table of phases, each product phase's operands by its number and
// then the split product, each phase of adds by its number.  Returns 0,
// or -1 if two tasks of one phase wrote the same word.
extern "C" int host_final_exp(const int32_t* f, int32_t* out, int64_t lanes,
                              int order) {
  std::vector<uint32_t> s(final_exp::kScratch * fp384::kWords);
  for (int64_t lane = 0; lane < lanes; ++lane) {
    host::poison(s);
    load12(f + lane * kLane, s, final_exp::kT);
    bool ok = true;
    for (int i = 0;; ++i) {
      const int e = final_exp::phase_at(i), id = e & 0xff, tasks = e >> 8;
      if (id == final_exp::kEndPhase) break;
      if (id < final_exp::kProducts) {
        ok = host::run_tasks(s, tasks, order, [&](int k, uint32_t* x) {
          uint32_t a[fp384::kWords], b[fp384::kWords], r[fp384::kWords];
          const int at = final_exp::product_operands(id, k, x, a, b);
          if (at < 0) return;
          host::split_mul(a, b, r, order == 1);
          fp12::st(x, at, r);
        }) && ok;
      } else {
        ok = host::run_tasks(s, tasks, order, [&](int k, uint32_t* x) {
          final_exp::linear_task(id, k, x);
        }) && ok;
      }
    }
    if (!ok) return -1;
    store12(s, final_exp::kAcc, out + lane * kLane);
  }
  return 0;
}

// One step of the program on lanes whose ACC, BASE and input slots hold
// acc, base and t; ACC and BASE after it into acc_out and base_out.
extern "C" int host_final_exp_step(int step, const int32_t* acc,
                                   const int32_t* base, const int32_t* t,
                                   int32_t* acc_out, int32_t* base_out,
                                   int64_t lanes, int order) {
  std::vector<uint32_t> s(final_exp::kScratch * fp384::kWords);
  for (int64_t lane = 0; lane < lanes; ++lane) {
    host::poison(s);
    load12(acc + lane * kLane, s, final_exp::kAcc);
    load12(base + lane * kLane, s, final_exp::kBase);
    load12(t + lane * kLane, s, final_exp::kT);
    if (!final_exp::run_step(host::Runner{&s, order}, step)) return -1;
    store12(s, final_exp::kAcc, acc_out + lane * kLane);
    store12(s, final_exp::kBase, base_out + lane * kLane);
  }
  return 0;
}
"""

_ORDERS = {"forward": 0, "reverse": 1, "isolated": 2}
# csrc/final_exp.cuh's Op
_OPS = {"end": 0, "inverse": 1, "square": 2, "mul": 3, "frob1": 4,
        "frob2": 5}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of final_exp.cuh "
                    "needs a C++17 compiler")
    tmp = tmp_path_factory.mktemp("final_exp_host")
    header = tmp / "harmony_params.h"
    header.write_text(_build.params_header())
    src = tmp / "final_exp_host.cpp"
    src.write_text(_HOST_SRC)
    so = tmp / "final_exp_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-include", str(header),
                    "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_final_exp_program.argtypes = [ptr, i32]
    lib.host_final_exp_phases.argtypes = [ptr, i32]
    lib.host_final_exp.argtypes = [ptr, ptr, i64, i32]
    lib.host_final_exp_step.argtypes = [i32] + [ptr] * 5 + [i64, i32]
    return lib


def _ptr(x):
    return x.ctypes.data


def _random_fp12(g, lanes):
    a = g.integers(0, 4096, size=(lanes, 2, 3, 2, 32), dtype=np.int32)
    a[..., 31] = g.integers(0, 416, size=(lanes, 2, 3, 2))  # below p's top
    return a


def _one(lanes):
    return TT.fp12_one((lanes,)).numpy()


@functools.lru_cache(maxsize=None)
def _real_pair():
    """(the Miller value, the bigint pairing) of e(3 G1, 5 G2): the JAX
    package's projective Miller loop, the port's algorithm, in bigints."""
    p, q = RC.g1.mul(RC.G1_GEN, 3), RC.g2.mul(RC.G2_GEN, 5)
    f = RP.miller_loop_projective(p, q)
    return TI.fp12_to_arr(f).numpy(), RP.pairing(p, q)


@pytest.fixture(scope="module")
def lanes():
    """Five lanes of f: two seeded random values, 0, 1 and the Miller
    value of a real pair; and the plain final exponentiation of each,
    computed once."""
    g = np.random.default_rng(0xF1E)
    f = np.concatenate([_random_fp12(g, 2),
                        np.zeros((1, 2, 3, 2, 32), np.int32), _one(1),
                        _real_pair()[0][None]])
    return f, TPR.final_exponentiation_reference(torch.from_numpy(f)).numpy()


@pytest.mark.parametrize("order", sorted(_ORDERS))
def test_program_equals_the_plain_final_exponentiation(host_lib, lanes,
                                                       order):
    f, want = lanes
    got = np.empty_like(f)
    assert host_lib.host_final_exp(_ptr(f), _ptr(got), len(f),
                                   _ORDERS[order]) == 0, \
        "two tasks of one phase write the same word"
    np.testing.assert_array_equal(got, want)


def test_real_pair_gives_the_bigint_pairing(lanes):
    """The real pair's lane (the plain version, which the program equals
    bit for bit) is the JAX package's bigint e(P, Q), the cubed pairing;
    the zero lane stays 0 and the lane of one stays one."""
    _, want = lanes
    assert TI.arr_to_fp12(torch.from_numpy(want[4])) == _real_pair()[1]
    assert not want[2].any()
    np.testing.assert_array_equal(want[3], _one(1)[0])


def test_program_replays_the_plain_schedules(host_lib):
    """The program makes the plain version's 35 Fp12 products and its
    315 squarings in the runs of |x - 1|'s and |x|'s schedules, with one
    inverse and three Frobenius maps (p^2, p, p^2)."""
    steps = np.zeros(256, np.int32)
    n = host_lib.host_final_exp_program(_ptr(steps), len(steps))
    ops, args = steps[:n] & 0xFF, steps[:n] >> 8
    assert ops[-1] == _OPS["end"]
    assert (ops == _OPS["mul"]).sum() == 35
    assert (ops == _OPS["inverse"]).sum() == 1 and ops[0] == _OPS["inverse"]
    frobs = [op for op in ops if op in (_OPS["frob1"], _OPS["frob2"])]
    assert frobs == [_OPS["frob2"], _OPS["frob1"], _OPS["frob2"]]
    runs = args[ops == _OPS["square"]].tolist()
    want = []
    for sched in (S.XM1_SCHED, S.XM1_SCHED, S.X_SCHED, S.X_SCHED, S.X_SCHED):
        want += list(sched[0])
    assert runs == want and sum(runs) == 315


def _step_inputs():
    """ACC, BASE and the input slot for six lanes: four seeded random
    values, then 0 and 1 in every slot."""
    g = np.random.default_rng(0xF1F)
    acc, base, t = (np.concatenate([_random_fp12(g, 4),
                                    np.zeros((1, 2, 3, 2, 32), np.int32),
                                    _one(1)]) for _ in range(3))
    return acc, base, t


@functools.lru_cache(maxsize=None)
def _plain_step(step):
    """(ACC, BASE) after the step on _step_inputs, by the plain versions,
    computed once."""
    acc, base, t = (torch.from_numpy(x) for x in _step_inputs())
    if step == "inverse":
        out = TT.fp12_conj(t), TT.fp12_inv(t)
    elif step == "mul":
        out = TT.fp12_mul_reference(acc, base), base
    elif step == "square":  # the product on (a, a), as fp12_mul.cu
        out = TT.fp12_sqr_reference(base), base
    else:
        out = acc, TT.fp12_frobenius(base, 1 if step == "frob1" else 2)
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("step", ["frob1", "frob2", "inverse", "mul",
                                  "square"])
def test_step_equals_the_plain_version(host_lib, step, order):
    """One step alone: the inverse (BASE = f^-1, ACC = conj(f), with
    0 -> 0), the Frobenius maps of BASE, and the Fp12 product ACC = ACC
    BASE on random pairs, 0 and 1, and on (a, a) ("square")."""
    acc, base, t = _step_inputs()
    if step == "square":
        acc = base.copy()
    op = _OPS["mul" if step == "square" else step]
    acc_out, base_out = np.empty_like(acc), np.empty_like(base)
    rc = host_lib.host_final_exp_step(op, _ptr(acc), _ptr(base), _ptr(t),
                                      _ptr(acc_out), _ptr(base_out),
                                      len(acc), _ORDERS[order])
    assert rc == 0, "two tasks of one phase write the same word"
    want_acc, want_base = _plain_step(step)
    np.testing.assert_array_equal(acc_out, want_acc)
    np.testing.assert_array_equal(base_out, want_base)


def test_phase_table_runs_the_program(host_lib):
    """The card's table of phases is the program's plans in order: 315
    squarings of three phases (the sums, the products with operands not
    reduced, Next), 35 Fp12 products of six, the inverse's 19 phases, three
    Frobenius maps of two, and the moves, then the end."""
    steps = np.zeros(256, np.int32)
    n = host_lib.host_final_exp_program(_ptr(steps), len(steps))
    entries = np.zeros(2048, np.int32)
    m = host_lib.host_final_exp_phases(_ptr(entries), len(entries))
    ids = entries[:m] & 0xFF
    assert ids[-1] == 0xFF and (ids[:-1] != 0xFF).all()
    plan_phases = {_OPS["inverse"]: 19, _OPS["square"]: 3, _OPS["mul"]: 6,
                   _OPS["frob1"]: 2, _OPS["frob2"]: 2}
    want = sum(plan_phases.get(op, 1) * (arg if op == _OPS["square"] else 1)
               for op, arg in zip(steps[:n - 1] & 0xFF, steps[:n - 1] >> 8))
    assert m - 1 == want
