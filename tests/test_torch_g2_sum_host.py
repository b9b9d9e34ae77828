"""The masked G2 sum kernel's plans and its partition over blocks, on the
CPU.

``harmony_tpu_torch/csrc/g2_masked_sum.cu`` sums the tree of
``ops/curve.py`` masked_sum over blocks: block g of the first stage sums
the leaves congruent to g mod the stage's blocks (4 at most) by the
reference's levels, and of each group of blocks whose partials meet, the
last to finish (a counter in device memory) sums their partials in the
next stage, until one block writes the sum.  Each add runs
``jac::sum``'s plan (``csrc/jac.cuh``): five rounds of products that
only load their operands, each but the last followed by one phase of
adds, the doubling's three rounds where the operands are equal, then the
result with curve.py add's selects.  Outside nvcc the plans and the
partition (``jac::sum::stage``, ``needs``) are plain C++, so here g++
compiles them through a host harness that runs the kernel's schedule:
the stages, each block's levels on its adds' scratch areas (the result
kept in place of p1, p2 taken from add k + half's, everything else
poisoned before each add), the partials in a workspace, the counters and
the last block of each group going on; the blocks of the first stage in
order, in reverse, or odd ones first (so that another block is last);
each phase's tasks forward, in reverse or isolated (each task on the
scratch area as the phase found it; two tasks writing one word fail),
every product the split product with its threads stepped.

Each sum must equal the plain version (``masked_sum_reference``) bit for
bit (Jacobian limbs, tolerance 0: they depend on the formula, and the
plans keep the reference's), over G2 and G1 (the plan is one template):
at 0, 1, 2, 3, 5, 17 and 200 points with one block, two blocks and the
kernel's own partition, and at 1,024 with the kernel's; under masks of
every point, none, a mix with words 2 and -1, two equal points alone (so
that they meet in the last level, in the last block's stage) and a point
and its negative alone; with a point twice and a point and its negative
meeting on the first level, and points with Z = 1, Z != 1 and infinity.
Without g++ the tests skip.  No JAX program is compiled here.
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from harmony_tpu_torch.kernels import _build
from harmony_tpu_torch.kernels import g2_masked_sum as KG2
from harmony_tpu_torch.ops import bls as TB
from harmony_tpu_torch.ops import curve as TCV
from harmony_tpu_torch.ops import interop as TI
from harmony_tpu_torch.ref.curve import G1_GEN, G2_GEN, g1, g2
from test_torch_fp12_host import HOST_RUNNER

# Counts the modular adds and subs of phases.cuh (its PHASES_COUNT_OP hook)
_COUNTER = r"""
#include <cstdint>
namespace host_ops {
inline int64_t count = 0;
}
#define PHASES_COUNT_OP() (++host_ops::count)
"""

_HOST_SRC = _COUNTER + HOST_RUNNER + r"""
#include "jac.cuh"

namespace {

using host::load;
using host::store;
constexpr int kWords = fp384::kWords;
constexpr int kLimbs = fp384::kLimbs;

// The masked sum as g2_masked_sum.cu schedules it, over field F.
template <class F>
struct Sum {
  using S = jac::sum::Slots<F>;
  static constexpr int kPoint = 3 * F::kE, kPW = kPoint * kWords;
  const int32_t* points;
  const int32_t* mask;
  int64_t n;
  int most, order;
  std::vector<uint32_t> partials;
  std::vector<int> counters;
  std::vector<uint32_t> result;
  int sums = 0;
  bool ok = true;

  // Element e of input i of a stage into element `to` of s: at stage 0
  // leaf i (the point where i < n and its mask word is 1, else (1, 1, 0)),
  // after it partial `in` + i.
  void input(int stage, int in, int i, int e, uint32_t* s, int to) const {
    if (stage > 0) {
      for (int j = 0; j < kWords; ++j) {
        s[to * kWords + j] = partials[(in + i) * kPW + e * kWords + j];
      }
    } else if (i < n && mask[i] == 1) {
      load(points + (static_cast<int64_t>(i) * kPoint + e) * kLimbs, s, to);
    } else {
      uint32_t w[kWords];
      jac::infinity_element<F>(e, w);
      fp12::st(s, to, w);
    }
  }

  // Block g of a stage, its inputs from partial `in` on, its partials to
  // `at` on, its groups' counters from `counter` on; where it is the last
  // of its group, the stages after.
  void block(jac::sum::Stage st, int g) {
    int stage = 0, in = 0, at = 0, counter = 0;
    for (;;) {
      const int half0 = st.leaves / 2;
      std::vector<uint32_t> res(kPW);
      if (half0 == 0) {  // one leaf
        for (int e = 0; e < kPoint; ++e) input(stage, in, g, e, res.data(), e);
      } else {
        std::vector<std::vector<uint32_t>> s(
            half0, std::vector<uint32_t>(S::kEnd * kWords));
        for (int a = 0; a < half0; ++a) {
          host::poison(s[a]);
          for (int e = 0; e < kPoint; ++e) {
            input(stage, in, g + a * st.blocks, e, s[a].data(), S::kP1 + e);
            input(stage, in, g + (a + half0) * st.blocks, e, s[a].data(),
                  S::kP2 + e);
          }
        }
        for (int half = half0; half >= 1; half /= 2) {
          for (int a = 0; a < half; ++a) {
            if (half < half0) {
              for (int j = 0; j < kPW; ++j) {
                s[a][S::kP2 * kWords + j] = s[a + half][S::kP1 * kWords + j];
              }
            }
            for (std::size_t j = (S::kP2 + kPoint) * kWords; j < s[a].size();
                 ++j) {
              s[a][j] = 0xa5a5a5a5u;
            }
            const host::Runner run{&s[a], order};
            ok = jac::sum::add<F>(run, s[a].data()) && ok;
          }
        }
        for (int j = 0; j < kPW; ++j) res[j] = s[0][S::kP1 * kWords + j];
      }
      if (st.blocks == 1) {
        result = res;
        ++sums;
        return;
      }
      for (int j = 0; j < kPW; ++j) partials[(at + g) * kPW + j] = res[j];
      const jac::sum::Stage next = jac::sum::stage(st.blocks, most);
      const int group = g % next.blocks;
      if (++counters[counter + group] != next.leaves) return;
      in = at;
      at += st.blocks;
      counter += next.blocks;
      st = next;
      g = group;
      ++stage;
    }
  }
};

// blocks: 0 in order, 1 in reverse, 2 the odd ones first.
template <class F>
int masked_sum(const int32_t* points, const int32_t* mask, int64_t n,
               int most, int order, int blocks, int32_t* out) {
  const int size = jac::leaves(n);
  const jac::sum::Needs need = jac::sum::needs(size, most);
  Sum<F> sum{points, mask, n, most, order};
  sum.partials.assign(need.partials * Sum<F>::kPW, 0xa5a5a5a5u);
  sum.counters.assign(need.counters, 0);
  const jac::sum::Stage first = jac::sum::stage(size, most);
  std::vector<int> gs;
  for (int g = 0; g < first.blocks; ++g) gs.push_back(g);
  if (blocks == 1) {
    std::vector<int> r(gs.rbegin(), gs.rend());
    gs = r;
  } else if (blocks == 2) {
    std::vector<int> r;
    for (int g = 1; g < first.blocks; g += 2) r.push_back(g);
    for (int g = 0; g < first.blocks; g += 2) r.push_back(g);
    gs = r;
  }
  for (int g : gs) sum.block(first, g);
  if (sum.sums != 1 || !sum.ok) return -1;
  for (int e = 0; e < Sum<F>::kPoint; ++e) {
    store(sum.result.data(), e, out + e * kLimbs);
  }
  return 0;
}

// Counts what one add's plans run: Montgomery products, and the modular
// adds and subs of the product tasks (forming operands) and of the phases
// of adds, apart.
struct Counter {
  std::vector<uint32_t>* s;
  int64_t* counts;

  template <class Ph>
  bool phase() const {
    for (int k = 0; k < Ph::kTasks; ++k) {
      const int64_t before = host_ops::count;
      if constexpr (Ph::kProduct) {
        uint32_t x[kWords], y[kWords], r[kWords];
        const int at = Ph::operands(k, s->data(), x, y);
        counts[1] += host_ops::count - before;
        fp384::mont_mul(x, y, r);
        fp12::st(s->data(), at, r);
        ++counts[0];
      } else {
        Ph::task(k, s->data());
        counts[2] += host_ops::count - before;
      }
    }
    return true;
  }

  template <class... Ph>
  bool operator()(phases::Plan<Ph...>) const {
    (phase<Ph>(), ...);
    return true;
  }
};

template <class F>
void count_add(const int32_t* p1, const int32_t* p2, int64_t* counts) {
  using S = jac::sum::Slots<F>;
  std::vector<uint32_t> s(S::kEnd * kWords);
  host::poison(s);
  for (int e = 0; e < 3 * F::kE; ++e) {
    load(p1 + e * kLimbs, s.data(), S::kP1 + e);
    load(p2 + e * kLimbs, s.data(), S::kP2 + e);
  }
  counts[0] = counts[1] = counts[2] = 0;
  const Counter run{&s, counts};
  jac::sum::add<F>(run, s.data());
}

template <class F>
void sizes(int32_t* out) {
  constexpr jac::ladder::Table t = jac::sum::make_table<F>();
  out[0] = jac::sum::Slots<F>::kEnd;
  for (int r = 0; r < jac::sum::kRounds; ++r) out[1 + r] = t.n[r];
}

}  // namespace

extern "C" int host_g2_sum(int field, const int32_t* points,
                           const int32_t* mask, int64_t n, int most,
                           int order, int blocks, int32_t* out) {
  return field == 1
             ? masked_sum<jac::Fp>(points, mask, n, most, order, blocks, out)
             : masked_sum<jac::Fp2>(points, mask, n, most, order, blocks,
                                    out);
}

extern "C" void host_count_add(int field, const int32_t* p1,
                               const int32_t* p2, int64_t* counts) {
  if (field == 1) {
    count_add<jac::Fp>(p1, p2, counts);
  } else {
    count_add<jac::Fp2>(p1, p2, counts);
  }
}

// An add's scratch elements, then the products of each round, by field.
extern "C" void host_sizes(int field, int32_t* out) {
  if (field == 1) {
    sizes<jac::Fp>(out);
  } else {
    sizes<jac::Fp2>(out);
  }
}

// The stages of a sum of `size` leaves, a block summing `most` inputs at
// most: (width, blocks, leaves) of each; then the workspace's counters and
// partials and the most adds a block runs at once.  Returns the stages.
extern "C" int host_stages(int size, int most, int32_t* out) {
  int k = 0;
  for (jac::sum::Stage st = jac::sum::stage(size, most);;
       st = jac::sum::stage(st.blocks, most)) {
    out[3 * k] = st.width;
    out[3 * k + 1] = st.blocks;
    out[3 * k + 2] = st.leaves;
    ++k;
    if (st.blocks == 1) break;
  }
  const jac::sum::Needs need = jac::sum::needs(size, most);
  out[3 * k] = need.counters;
  out[3 * k + 1] = need.partials;
  out[3 * k + 2] = need.adds;
  return k;
}

extern "C" int host_block_leaves() { return jac::sum::kBlockLeaves; }
"""

_ORDERS = {"forward": 0, "reverse": 1, "isolated": 2}
# the first stage's blocks: in order with the tasks forward, in reverse
# with them reversed, the odd ones first with them isolated
_BLOCK_ORDERS = {"forward": 0, "reverse": 1, "isolated": 2}
_FIELDS = {"g1": (1, TCV.FP_OPS, (3, 32)), "g2": (2, TCV.FP2_OPS, (3, 2, 32))}
SIZES = (0, 1, 2, 3, 5, 17, 200)
# the most products a round and an add's scratch elements, per field:
# rounds 1-5 the addition's (60 over Fp2, schoolbook), 6-8 the doubling's
_ROUNDS = {"g1": (3, 4, 4, 3, 2, 3, 3, 1), "g2": (10, 16, 15, 11, 8, 10, 9, 4)}
_SCRATCH = {"g1": 54, "g2": 144}

rng = random.Random(0x6253)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of jac.cuh needs a "
                    "C++17 compiler")
    tmp = tmp_path_factory.mktemp("g2_sum_host")
    header = tmp / "harmony_params.h"
    header.write_text(_build.params_header())
    src = tmp / "g2_sum_host.cpp"
    src.write_text(_HOST_SRC)
    so = tmp / "g2_sum_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-include", str(header),
                    "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=180)
    lib = ctypes.CDLL(str(so))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_g2_sum.argtypes = [i32, ptr, ptr, i64, i32, i32, i32, ptr]
    lib.host_count_add.argtypes = [i32, ptr, ptr, ptr]
    lib.host_count_add.restype = None
    lib.host_sizes.argtypes = [i32, ptr]
    lib.host_sizes.restype = None
    lib.host_stages.argtypes = [i32, i32, ptr]
    return lib


def _ptr(x):
    return x.ctypes.data


def _stages(lib, size, most):
    """[(width, blocks, leaves) of each stage], (counters, partials, adds)."""
    out = np.zeros(3 * 16, dtype=np.int32)
    k = lib.host_stages(size, most, _ptr(out))
    rows = [tuple(int(v) for v in out[3 * i:3 * i + 3]) for i in range(k + 1)]
    return rows[:k], rows[k]


def _points(field, n):
    """n points of the group: a chain P0 + i D (distinct), each third
    with Z = 1 and the rest doubled (Z != 1), point 5 at infinity; point
    1 equal to point 0 and point 3 the negative of point 2; where the
    tree's first level has 4 adds or more, point half equal to point 0
    and point half + 2 the negative of point 2 (they meet on that level)."""
    group, gen = (g1, G1_GEN) if field == "g1" else (g2, G2_GEN)
    ops = _FIELDS[field][1]
    p, d = group.mul(gen, rng.randrange(2, 1 << 64)), \
        group.mul(gen, rng.randrange(2, 1 << 64))
    aff = [p]
    while len(aff) < max(n, 1):
        aff.append(group.add(aff[-1], d))
    if field == "g1":
        jac = TCV.affine_to_jacobian_g1(TI.g1_batch_affine(aff))
    else:
        jac = TB._affine_to_jacobian_g2(TI.g2_batch_affine(aff))
    pts = torch.where(
        (torch.arange(len(aff)) % 3 == 0)[(...,) + (None,) * (jac.dim() - 1)],
        jac, TCV.dbl(jac, ops))[:n].clone()
    if n > 5:
        pts[5] = TCV.infinity(ops)
    if n > 1:
        pts[1] = pts[0]
    if n > 3:
        pts[3] = TCV.neg(pts[2], ops)
    half = _half(n)
    if half >= 4 and half + 2 < n:
        pts[half] = pts[0]
        pts[half + 2] = TCV.neg(pts[2], ops)
    return pts


def _half(n):
    """Half the leaves of n points (masked_sum pads to a power of two)."""
    size = 1
    while size < n:
        size *= 2
    return size // 2


def _masks(n):
    """Every point; none; a mix with words 2 and -1; points 0 and 1 alone
    (equal: they meet on the last level); points 2 and 3 alone (a point
    and its negative)."""
    masks = {"every": [1] * n, "none": [0] * n,
             "mix": [rng.choice((1, 1, 1, 0, 2, -1)) for _ in range(n)]}
    if n > 1:
        masks["pair"] = [1, 1] + [0] * (n - 2)
    if n > 3:
        masks["negative"] = [0, 0, 1, 1] + [0] * (n - 4)
    return {k: torch.tensor(v, dtype=torch.int32) for k, v in masks.items()}


def _sum(lib, field, points, mask, most, order):
    code, _, tail = _FIELDS[field]
    pts = np.ascontiguousarray(points.numpy())
    m = np.ascontiguousarray(mask.numpy())
    out = np.zeros(tail, dtype=np.int32)
    assert lib.host_g2_sum(code, _ptr(pts), _ptr(m), len(m), most,
                           _ORDERS[order], _BLOCK_ORDERS[order],
                           _ptr(out)) == 0
    return out


def _partitions(lib, n):
    """The leaves a block sums at most, for one block, two blocks and the
    kernel's own partition, without repeats."""
    size = 2 * _half(n) if n > 1 else 1
    own = lib.host_block_leaves()
    return sorted({max(size, 2), max(size // 2, 2), own})


@pytest.fixture(scope="module")
def cases():
    """Per field and size: the points, the masks and the plain version's
    sum under each."""
    out = {}
    for field, (_, ops, _) in _FIELDS.items():
        for n in SIZES + (1024,):
            if field == "g1" and n == 1024:
                continue
            pts = _points(field, n)
            masks = _masks(n)
            if n == 1024:
                masks = {k: masks[k] for k in ("mix", "pair")}
            out[field, n] = (pts, {
                k: (m, TCV.masked_sum_reference(pts, m, ops).numpy())
                for k, m in masks.items()})
    return out


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("field", sorted(_FIELDS))
def test_sum_equals_the_plain_version(host_lib, cases, field, order):
    for n in SIZES:
        pts, masks = cases[field, n]
        for most in _partitions(host_lib, n):
            for what, (mask, want) in masks.items():
                np.testing.assert_array_equal(
                    _sum(host_lib, field, pts, mask, most, order), want,
                    err_msg=str((field, n, most, what)))


@pytest.mark.parametrize("order", sorted(_ORDERS))
def test_1024_points_at_the_kernels_partition(host_lib, cases, order):
    """The widest bucket as the kernel splits it: 256 blocks of 4 leaves,
    then 64, 16, 4 and one block of 4 partials each."""
    own = host_lib.host_block_leaves()
    assert _stages(host_lib, 1024, own)[0] == [
        (1024, 256, 4), (256, 64, 4), (64, 16, 4), (16, 4, 4), (4, 1, 4)]
    pts, masks = cases["g2", 1024]
    for what, (mask, want) in masks.items():
        np.testing.assert_array_equal(
            _sum(host_lib, "g2", pts, mask, own, order), want, err_msg=what)


def test_equal_operands_meet_in_the_last_blocks_levels(host_lib, cases):
    """At 200 points under the kernel's partition (64 blocks, 16, 4, then
    one), two equal points alone meet on the last level, in the last
    block's stage: the doubling there.  Equal partials too: points 0 and 1
    equal to P, points 16 and 17 to Q (they meet at half 16, before the
    last stage, whose inputs hold the leaves 0, 1, 2 and 3 mod 4) give
    the last stage's partials 0 and 1 both P + Q, which double there."""
    pts, masks = cases["g2", 200]
    own = host_lib.host_block_leaves()
    assert _stages(host_lib, 256, own)[0] == [
        (256, 64, 4), (64, 16, 4), (16, 4, 4), (4, 1, 4)]
    mask, want = masks["pair"]
    got = _sum(host_lib, "g2", pts, mask, own, "forward")
    np.testing.assert_array_equal(got, want)
    twice = pts.clone()
    twice[1] = pts[0]
    twice[16] = twice[17] = pts[4]
    mask = torch.zeros(200, dtype=torch.int32)
    mask[[0, 1, 16, 17]] = 1
    want = TCV.masked_sum_reference(twice, mask, TCV.FP2_OPS).numpy()
    for order in _ORDERS:
        np.testing.assert_array_equal(
            _sum(host_lib, "g2", twice, mask, own, order), want)


def test_the_partition_is_one_pass_a_level(host_lib):
    """For every size the kernel takes: each stage's block sums at most 4
    inputs (2 adds, 128 threads: every level one pass), the levels add up
    to log2 of the leaves, the first stage's blocks hold 4 leaves from 8
    points on, and the counters and partials fit the wrapper's
    workspace (exactly at 1,024)."""
    own = host_lib.host_block_leaves()
    assert own == 4
    for size in (2 ** k for k in range(11)):
        stages, (counters, partials, adds) = _stages(host_lib, size, own)
        assert all(b * leaves == w and leaves <= own
                   for w, b, leaves in stages)
        assert stages[-1][1] == 1
        assert [w for w, _, _ in stages[1:]] == [b for _, b, _ in
                                                  stages[:-1]]
        levels = sum(leaves.bit_length() - 1 for _, _, leaves in stages)
        assert levels == size.bit_length() - 1, size
        assert adds == max(1, max(leaves // 2 for _, _, leaves in stages))
        if size >= 8:
            assert stages[0][2] == 4
        assert counters <= 128
        assert 128 + 72 * partials <= KG2.WORKSPACE_WORDS
        if size == 1024:
            assert (counters, partials, adds) == (85, 340, 2)
            assert 128 + 72 * partials == KG2.WORKSPACE_WORDS


def test_the_rounds_only_load_their_operands(host_lib, cases):
    """An add's plans: the rounds' products (over Fp2 60, then 23 for the
    doubling; over Fp 16 and 7), each round of 16 at most (one pass of an
    add's 16 groups), every product task loading its two operands and
    making no modular add or sub; and an add's scratch area of 144
    elements over Fp2, so that a block's 2 adds, the table and its flag
    take 14,340 B of static shared memory."""
    for field, (code, _, _) in _FIELDS.items():
        sizes = np.zeros(9, dtype=np.int32)
        host_lib.host_sizes(code, _ptr(sizes))
        assert sizes[0] == _SCRATCH[field]
        assert tuple(sizes[1:]) == _ROUNDS[field]
        assert max(sizes[1:]) <= 16
        pts = cases[field, 5][0]
        for p1, p2, doubles in ((pts[0], pts[1], True),
                                (pts[0], pts[2], False)):
            counts = np.zeros(3, dtype=np.int64)
            host_lib.host_count_add(code, _ptr(np.ascontiguousarray(p1)),
                                    _ptr(np.ascontiguousarray(p2)),
                                    _ptr(counts))
            rounds = _ROUNDS[field]
            assert counts[0] == sum(rounds[:5]) + doubles * sum(rounds[5:])
            assert counts[1] == 0 and counts[2] > 0
    assert 2 * 144 * 48 + 8 * 16 * 4 + 4 == 14340


def test_the_timed_build_takes_the_kernels_arguments_and_no_launch():
    """kernels/g2_masked_sum.py phase_clocks, the sum's timed build: its
    record's size is the source's, its entry point takes the kernel's
    arguments and the record, and off the card it raises as the kernel
    does, counting no launch."""
    src = (_build.CSRC / "g2_masked_sum.cu").read_text()
    assert "buffer of 4 + kParts (18) words" in src
    assert KG2.CLOCK_WORDS == 4 + len(KG2.PARTS) == 18
    assert "constexpr int kCounterWords = 128;" in src
    timed = _build._ENTRY_POINTS["harmony_g2_masked_sum_phases"]
    plain = _build._ENTRY_POINTS["harmony_g2_masked_sum"]
    assert timed == plain[:3] + [ctypes.c_void_p] + plain[3:]
    before = KG2.LAUNCHES
    for device in ("cpu", "meta"):
        pts = torch.zeros(2, 3, 2, 32, dtype=torch.int32, device=device)
        with pytest.raises(ValueError, match="CUDA"):
            KG2.phase_clocks(pts, torch.ones(2, device=device))
    with pytest.raises(TypeError, match="int32"):
        KG2.phase_clocks(torch.empty(2, 3, 2, 32, device="meta"),
                         torch.ones(2, device="meta"))
    assert KG2.LAUNCHES == before
