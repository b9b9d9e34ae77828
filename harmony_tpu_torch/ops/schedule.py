"""Static square-and-multiply schedules of BLS |x| and |x - 1|: the
Miller loop's (``ops/pairing.py`` and the ``miller_loop`` kernel, which
gets it through the header ``kernels/_build.py`` generates) and the
final exponentiation's cyclotomic powers.
"""

from . import _constants as C


def schedule(e: int):
    """Square-and-multiply schedule of a STATIC exponent as two equal-
    length tuples: per segment, the number of squarings, then whether a
    multiply follows.  BLS |x| has hamming weight 6, so the schedule is
    6 segments: 63 squarings + 5 multiplies."""
    bits = bin(e)[2:]
    runs, zeros = [], 0
    for ch in bits[1:]:
        if ch == "0":
            zeros += 1
        else:
            runs.append(zeros + 1)
            zeros = 0
    n_sqr = list(runs)
    do_mul = [1] * len(runs)
    if zeros:
        n_sqr.append(zeros)
        do_mul.append(0)
    return tuple(n_sqr), tuple(do_mul)


ABS_X = -C.BLS_X  # 0xd201000000010000
X_SCHED = schedule(ABS_X)
XM1_SCHED = schedule(ABS_X + 1)  # |x - 1| = |x| + 1 (x < 0)
