"""Generate harmony_tpu_torch/ops/_constants.py — every constant the
kernels need, derived with the bigint reference layer and emitted in limb
form (kernels/_build.py turns the values into the CUDA build's header).

Run:  python -m harmony_tpu_torch.ref.constants_gen
The emitted file is committed; tests/test_torch_constants_gen.py
regenerates it and asserts equality, so the kernels can never drift from
the reference.

Montgomery domain: base beta = 2^12, R = beta^32 = 2^384.
Frobenius: gamma_n[m] = xi^(m (p^n - 1) / 6) for the coefficient of
w^i v^j with m = i + 2 j (tower Fp12 = Fp6[w]/(w^2 - v), Fp6 = Fp2[v]/
(v^3 - xi), xi = u + 1).

The port's copy of the JAX package's ``ref/constants_gen.py``.
"""

import io

from . import fields as F
from .params import B_G1, G1_X, G1_Y, G2_X, G2_Y, H1, H2, P, R_ORDER, X, XI

LIMB_BITS = 12
N_LIMBS = 32
R_MONT = 1 << (LIMB_BITS * N_LIMBS)


def _to_mont(a: int) -> int:
    return a * R_MONT % P


def _fp2_to_mont(a):
    return (_to_mont(a[0]), _to_mont(a[1]))


def _limbs(x: int):
    return [(x >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1) for i in range(N_LIMBS)]


def generate() -> str:
    p_inv_neg = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    r2 = R_MONT * R_MONT % P

    # Frobenius gamma_n[m] = xi^(m (p^n - 1) / 6), n = 1..3, m = 0..5.
    frob = []
    for n in (1, 2, 3):
        exp_unit = (P**n - 1) // 6
        row = []
        for m in range(6):
            gamma = F.fp2_conj(F.FP2_ONE)  # placeholder; computed below
            gamma = _fp2_pow(XI, m * exp_unit)
            row.append(_fp2_to_mont(gamma))
        frob.append(row)

    out = io.StringIO()
    w = out.write
    w('"""GENERATED by harmony_tpu_torch.ref.constants_gen — do not edit.\n\n')
    w("Limb-form constants of BLS12-381: base 2^12, 32 limbs, Montgomery\n")
    w("R = 2^384.  Regenerated and compared in\n")
    w("tests/test_torch_constants_gen.py; tests/test_torch_fp.py holds every\n")
    w('value equal to the JAX package\'s.\n"""\n\n')
    w(f"LIMB_BITS = {LIMB_BITS}\n")
    w(f"N_LIMBS = {N_LIMBS}\n\n")
    w(f"P_INT = {P}\n")
    w(f"R_ORDER = {R_ORDER}\n")
    w(f"BLS_X = {X}\n")
    w(f"H1 = {H1}\n")
    w(f"H2 = {H2}\n")
    w(f"P_INV_NEG = {p_inv_neg}\n\n")
    w(f"P_LIMBS = {_limbs(P)}\n\n")
    w(f"# Montgomery form of 1 (= R mod p) and the conversion factor R^2 mod p\n")
    w(f"ONE_MONT = {_limbs(_to_mont(1))}\n\n")
    w(f"R2_LIMBS = {_limbs(r2)}\n\n")
    w(f"# curve constants in Montgomery form\n")
    w(f"B_G1_MONT = {_limbs(_to_mont(B_G1))}\n\n")
    xi_m = _fp2_to_mont(XI)
    w(f"XI_MONT = [{_limbs(xi_m[0])}, {_limbs(xi_m[1])}]\n\n")
    b2 = F.fp2_scalar(XI, B_G1)
    b2_m = _fp2_to_mont(b2)
    w(f"B_G2_MONT = [{_limbs(b2_m[0])}, {_limbs(b2_m[1])}]\n\n")
    w(f"# generators (affine, Montgomery form)\n")
    w(f"G1_GEN_MONT = [{_limbs(_to_mont(G1_X))}, {_limbs(_to_mont(G1_Y))}]\n\n")
    g2x, g2y = _fp2_to_mont(G2_X), _fp2_to_mont(G2_Y)
    w(f"G2_GEN_X_MONT = [{_limbs(g2x[0])}, {_limbs(g2x[1])}]\n")
    w(f"G2_GEN_Y_MONT = [{_limbs(g2y[0])}, {_limbs(g2y[1])}]\n\n")
    w("# Frobenius coefficients: FROB_GAMMA[n-1][m] = xi^(m (p^n - 1)/6)\n")
    w("# as Fp2 pairs of limb lists (Montgomery form); n = 1, 2, 3.\n")
    w("FROB_GAMMA = [\n")
    for row in frob:
        w("    [\n")
        for g in row:
            w(f"        [{_limbs(g[0])}, {_limbs(g[1])}],\n")
        w("    ],\n")
    w("]\n\n")
    w("# final-exponentiation hard part exponent (p^4 - p^2 + 1) / r\n")
    w(f"HARD_EXP = {(P**4 - P**2 + 1) // R_ORDER}\n")
    return out.getvalue()


def _fp2_pow(a, e):
    result = F.FP2_ONE
    base = a
    while e:
        if e & 1:
            result = F.fp2_mul(result, base)
        base = F.fp2_mul(base, base)
        e >>= 1
    return result


def main():
    import pathlib

    target = pathlib.Path(__file__).parent.parent / "ops" / "_constants.py"
    target.write_text(generate())
    print(f"wrote {target}")


if __name__ == "__main__":
    main()
