// Native host BLS12-381: the fast CPU crypto path of harmony-tpu.
//
// Role: the reference's L0 is herumi's hand-tuned C++ mcl library
// (reference: go.mod:27, Makefile:68-70) — every FBFT vote and block
// replay burns pairings inside it.  This library is the analogous
// native host path for THIS framework: the Python bigint twin
// (harmony_tpu/ref/) stays the auditable ground truth, the TPU ops
// (harmony_tpu/ops/) are the device path, and this file makes the host
// fallback fast enough to carry a live chain (ms-scale pairings vs the
// twin's ~240 ms).
//
// Conventions are EXACTLY the twin's, so GT elements, sqrt choices and
// hash-to-curve outputs are bitwise interchangeable:
//   Fp2  = Fp [u]/(u^2+1),  Fp6 = Fp2[v]/(v^3 - xi), xi = u+1,
//   Fp12 = Fp6[w]/(w^2 - v)
//   Miller loop: twist-Jacobian, sparse lines in {v^2, w, w v}
//     (ref/pairing.py::miller_loop_projective)
//   Final exp: CUBE of the reduced pairing via the x-addition chain
//     3λ = (x-1)^2 (x+p)(x^2+p^2-1) + 3  (ops/pairing.py chain)
//
// Arithmetic: 6x64-bit limbs, Montgomery form (R = 2^384), CIOS
// multiplication on unsigned __int128.  No assembly, no third-party
// code; every constant is derived at init from the prime and the BLS
// parameter x = -0xd201000000010000.
//
// ABI: flat byte buffers, big-endian 48-byte field elements.
//   G1 point: x||y (96 B) + explicit infinity flag.
//   G2 point: x.c0||x.c1||y.c0||y.c1 (192 B) + infinity flag.
//   GT:       12 x 48 B in ref-tuple order (c0.c0.c0, c0.c0.c1, ...).

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---------------------------------------------------------------------------
// Fp: 6x64 Montgomery
// ---------------------------------------------------------------------------

static const u64 P_LIMBS[6] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL,
};

static u64 NP;            // -p^-1 mod 2^64
static u64 R2_LIMBS[6];   // R^2 mod p (canonical limbs)
static u64 PM2[6];        // p - 2   (inversion exponent)
static u64 PP14[6];       // (p+1)/4 (sqrt exponent)
static u64 PM12[6];       // (p-1)/2 (is_neg threshold, canonical)

struct Fp {
    u64 v[6];
};

static inline bool fp_is_zero(const Fp &a) {
    u64 acc = 0;
    for (int i = 0; i < 6; i++) acc |= a.v[i];
    return acc == 0;
}

static inline bool fp_eq(const Fp &a, const Fp &b) {
    u64 acc = 0;
    for (int i = 0; i < 6; i++) acc |= a.v[i] ^ b.v[i];
    return acc == 0;
}

// canonical (non-Montgomery) limb compare: a >= b
static inline bool limbs_ge(const u64 *a, const u64 *b) {
    for (int i = 5; i >= 0; i--) {
        if (a[i] > b[i]) return true;
        if (a[i] < b[i]) return false;
    }
    return true;  // equal
}

static inline u64 limbs_sub(u64 *r, const u64 *a, const u64 *b) {
    u64 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a[i] - b[i] - borrow;
        r[i] = (u64)d;
        borrow = (u64)(d >> 64) & 1;
    }
    return borrow;
}

static inline u64 limbs_add(u64 *r, const u64 *a, const u64 *b) {
    u64 carry = 0;
    for (int i = 0; i < 6; i++) {
        u128 s = (u128)a[i] + b[i] + carry;
        r[i] = (u64)s;
        carry = (u64)(s >> 64);
    }
    return carry;
}

// branchless select: out = cond ? t : r  (cond in {0,1})
static inline void limbs_select(u64 *out, u64 cond, const u64 *t,
                                const u64 *r) {
    u64 mask = (u64)0 - cond;
    for (int i = 0; i < 6; i++) out[i] = (t[i] & mask) | (r[i] & ~mask);
}

static inline Fp fp_add(const Fp &a, const Fp &b) {
    Fp r;
    u64 carry = limbs_add(r.v, a.v, b.v);
    if (carry || limbs_ge(r.v, P_LIMBS)) limbs_sub(r.v, r.v, P_LIMBS);
    return r;
}

static inline Fp fp_sub(const Fp &a, const Fp &b) {
    Fp r;
    u64 borrow = limbs_sub(r.v, a.v, b.v);
    if (borrow) limbs_add(r.v, r.v, P_LIMBS);  // wraps mod 2^384: correct
    return r;
}

static inline Fp fp_neg(const Fp &a) {
    Fp r;
    if (fp_is_zero(a)) { memset(r.v, 0, sizeof r.v); return r; }
    limbs_sub(r.v, P_LIMBS, a.v);
    return r;
}

static inline Fp fp_dbl(const Fp &a) { return fp_add(a, a); }

// CIOS Montgomery multiplication: returns a*b*R^-1 mod p.
static Fp fp_mul(const Fp &a, const Fp &b) {
    u64 t[8];
    memset(t, 0, sizeof t);
    for (int i = 0; i < 6; i++) {
        u64 c = 0;
        for (int j = 0; j < 6; j++) {
            u128 s = (u128)a.v[i] * b.v[j] + t[j] + c;
            t[j] = (u64)s;
            c = (u64)(s >> 64);
        }
        u128 s = (u128)t[6] + c;
        t[6] = (u64)s;
        t[7] = (u64)(s >> 64);
        u64 m = t[0] * NP;
        s = (u128)m * P_LIMBS[0] + t[0];
        c = (u64)(s >> 64);
        for (int j = 1; j < 6; j++) {
            s = (u128)m * P_LIMBS[j] + t[j] + c;
            t[j - 1] = (u64)s;
            c = (u64)(s >> 64);
        }
        s = (u128)t[6] + c;
        t[5] = (u64)s;
        t[6] = t[7] + (u64)(s >> 64);
        t[7] = 0;
    }
    // result value = t[6]*2^384 + t[0..5] < 2p: at most one subtract
    Fp r;
    memcpy(r.v, t, sizeof r.v);
    if (t[6] || limbs_ge(r.v, P_LIMBS)) limbs_sub(r.v, r.v, P_LIMBS);
    return r;
}

static inline Fp fp_sqr(const Fp &a) { return fp_mul(a, a); }

static Fp FP_ZERO, FP_ONE, FP_R2, FP_INV2;  // ONE/INV2 in Montgomery form

// bytes (48, big-endian, canonical) <-> Montgomery limbs
static Fp fp_from_bytes(const uint8_t *b) {
    Fp r;
    for (int i = 0; i < 6; i++) {
        u64 x = 0;
        for (int j = 0; j < 8; j++) x = (x << 8) | b[(5 - i) * 8 + j];
        r.v[i] = x;
    }
    if (limbs_ge(r.v, P_LIMBS)) limbs_sub(r.v, r.v, P_LIMBS);
    return fp_mul(r, FP_R2);  // to Montgomery
}

static void fp_to_bytes(const Fp &a, uint8_t *out) {
    Fp one;
    memset(one.v, 0, sizeof one.v);
    one.v[0] = 1;
    Fp c = fp_mul(a, one);  // out of Montgomery
    for (int i = 0; i < 6; i++) {
        u64 x = c.v[5 - i];
        for (int j = 0; j < 8; j++) out[i * 8 + j] = (uint8_t)(x >> (56 - 8 * j));
    }
}

// generic pow by a canonical limb exponent (MSB-first scan)
static Fp fp_pow_limbs(const Fp &base, const u64 *e, int n) {
    Fp acc = FP_ONE;
    bool started = false;
    for (int i = n - 1; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            if (started) acc = fp_sqr(acc);
            if ((e[i] >> b) & 1) {
                if (!started) { acc = base; started = true; }
                else acc = fp_mul(acc, base);
            }
        }
    }
    return started ? acc : FP_ONE;
}

static inline Fp fp_inv(const Fp &a) { return fp_pow_limbs(a, PM2, 6); }

// principal sqrt a^((p+1)/4); ok=false if a is a non-residue.
static Fp fp_sqrt(const Fp &a, bool &ok) {
    Fp c = fp_pow_limbs(a, PP14, 6);
    ok = fp_eq(fp_sqr(c), a);
    return c;
}

// lexicographic 'sign' on the canonical value: a > (p-1)/2
static bool fp_is_neg(const Fp &a) {
    Fp one;
    memset(one.v, 0, sizeof one.v);
    one.v[0] = 1;
    Fp c = fp_mul(a, one);
    if (fp_is_zero(c)) return false;
    u64 t[6];
    // c > (p-1)/2  <=>  c >= (p-1)/2 + 1
    memcpy(t, PM12, sizeof t);
    u64 carry = 1;
    for (int i = 0; i < 6 && carry; i++) {
        u128 s = (u128)t[i] + carry;
        t[i] = (u64)s;
        carry = (u64)(s >> 64);
    }
    return limbs_ge(c.v, t);
}

// canonical compare for deterministic root choices: a < b (canonical ints)
static bool fp_canon_lt(const Fp &a, const Fp &b) {
    Fp one;
    memset(one.v, 0, sizeof one.v);
    one.v[0] = 1;
    Fp ca = fp_mul(a, one), cb = fp_mul(b, one);
    for (int i = 5; i >= 0; i--) {
        if (ca.v[i] < cb.v[i]) return true;
        if (ca.v[i] > cb.v[i]) return false;
    }
    return false;
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2+1)
// ---------------------------------------------------------------------------

struct Fp2 {
    Fp c0, c1;
};

static inline Fp2 fp2_add(const Fp2 &a, const Fp2 &b) {
    return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}
static inline Fp2 fp2_sub(const Fp2 &a, const Fp2 &b) {
    return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}
static inline Fp2 fp2_neg(const Fp2 &a) { return {fp_neg(a.c0), fp_neg(a.c1)}; }
static inline Fp2 fp2_dbl(const Fp2 &a) { return {fp_dbl(a.c0), fp_dbl(a.c1)}; }
static inline bool fp2_is_zero(const Fp2 &a) {
    return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
static inline bool fp2_eq(const Fp2 &a, const Fp2 &b) {
    return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}

// Karatsuba: 3 Fp muls
static inline Fp2 fp2_mul(const Fp2 &a, const Fp2 &b) {
    Fp v0 = fp_mul(a.c0, b.c0);
    Fp v1 = fp_mul(a.c1, b.c1);
    Fp cross = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
    return {fp_sub(v0, v1), fp_sub(cross, fp_add(v0, v1))};
}

// complex squaring: 2 Fp muls
static inline Fp2 fp2_sqr(const Fp2 &a) {
    Fp t0 = fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1));
    Fp t1 = fp_mul(a.c0, a.c1);
    return {t0, fp_dbl(t1)};
}

static inline Fp2 fp2_scale(const Fp2 &a, const Fp &s) {
    return {fp_mul(a.c0, s), fp_mul(a.c1, s)};
}

static inline Fp2 fp2_conj(const Fp2 &a) { return {a.c0, fp_neg(a.c1)}; }

// xi = u + 1: (a0 - a1) + (a0 + a1) u
static inline Fp2 fp2_mul_xi(const Fp2 &a) {
    return {fp_sub(a.c0, a.c1), fp_add(a.c0, a.c1)};
}

static inline Fp2 fp2_inv(const Fp2 &a) {
    Fp norm = fp_add(fp_sqr(a.c0), fp_sqr(a.c1));
    Fp ninv = fp_inv(norm);
    return {fp_mul(a.c0, ninv), fp_neg(fp_mul(a.c1, ninv))};
}

static Fp2 FP2_ZERO_C, FP2_ONE_C;

// generic Fp2 pow by canonical limb exponent (for Frobenius gammas at init)
static Fp2 fp2_pow_limbs(const Fp2 &base, const u64 *e, int n) {
    Fp2 acc = FP2_ONE_C;
    bool started = false;
    for (int i = n - 1; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            if (started) acc = fp2_sqr(acc);
            if ((e[i] >> b) & 1) {
                if (!started) { acc = base; started = true; }
                else acc = fp2_mul(acc, base);
            }
        }
    }
    return started ? acc : FP2_ONE_C;
}

// Deterministic sqrt mirroring ref/fields.py::fp2_sqrt exactly (same
// branch structure, same principal-root convention), so decompress and
// hash-to-curve agree with the bigint twin bit for bit.
static bool fp2_sqrt(const Fp2 &a, Fp2 &out) {
    bool ok;
    if (fp_is_zero(a.c1)) {
        Fp s = fp_sqrt(a.c0, ok);
        if (ok) { out = {s, FP_ZERO}; return true; }
        s = fp_sqrt(fp_neg(a.c0), ok);
        if (!ok) return false;
        out = {FP_ZERO, s};
        return true;
    }
    Fp alpha = fp_sqrt(fp_add(fp_sqr(a.c0), fp_sqr(a.c1)), ok);
    if (!ok) return false;
    Fp delta = fp_mul(fp_add(a.c0, alpha), FP_INV2);
    Fp x0 = fp_sqrt(delta, ok);
    if (!ok) {
        delta = fp_mul(fp_sub(a.c0, alpha), FP_INV2);
        x0 = fp_sqrt(delta, ok);
        if (!ok) return false;
    }
    Fp x1 = fp_mul(a.c1, fp_inv(fp_dbl(x0)));
    Fp2 cand = {x0, x1};
    if (!fp2_eq(fp2_sqr(cand), a)) return false;
    out = cand;
    return true;
}

// lexicographic sign of Fp2: compare (c1, c0) — serialize.py convention
static bool fp2_is_neg(const Fp2 &a) {
    if (!fp_is_zero(a.c1)) return fp_is_neg(a.c1);
    return fp_is_neg(a.c0);
}

// (y1, y0) > (n1, n0) canonical lexicographic — hash_to_curve choice
static bool fp2_lex_gt(const Fp2 &y, const Fp2 &n) {
    if (!fp_eq(y.c1, n.c1)) return fp_canon_lt(n.c1, y.c1);
    if (!fp_eq(y.c0, n.c0)) return fp_canon_lt(n.c0, y.c0);
    return false;
}

// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct Fp6 {
    Fp2 c0, c1, c2;
};
struct Fp12 {
    Fp6 c0, c1;
};

static inline Fp6 fp6_add(const Fp6 &a, const Fp6 &b) {
    return {fp2_add(a.c0, b.c0), fp2_add(a.c1, b.c1), fp2_add(a.c2, b.c2)};
}
static inline Fp6 fp6_sub(const Fp6 &a, const Fp6 &b) {
    return {fp2_sub(a.c0, b.c0), fp2_sub(a.c1, b.c1), fp2_sub(a.c2, b.c2)};
}
static inline Fp6 fp6_neg(const Fp6 &a) {
    return {fp2_neg(a.c0), fp2_neg(a.c1), fp2_neg(a.c2)};
}

// Karatsuba-3: 6 Fp2 muls (same formulas as ops/towers.py::fp6_mul)
static Fp6 fp6_mul(const Fp6 &a, const Fp6 &b) {
    Fp2 v0 = fp2_mul(a.c0, b.c0);
    Fp2 v1 = fp2_mul(a.c1, b.c1);
    Fp2 v2 = fp2_mul(a.c2, b.c2);
    Fp2 v12 = fp2_mul(fp2_add(a.c1, a.c2), fp2_add(b.c1, b.c2));
    Fp2 v01 = fp2_mul(fp2_add(a.c0, a.c1), fp2_add(b.c0, b.c1));
    Fp2 v02 = fp2_mul(fp2_add(a.c0, a.c2), fp2_add(b.c0, b.c2));
    Fp6 r;
    r.c0 = fp2_add(v0, fp2_mul_xi(fp2_sub(v12, fp2_add(v1, v2))));
    r.c1 = fp2_add(fp2_sub(v01, fp2_add(v0, v1)), fp2_mul_xi(v2));
    r.c2 = fp2_add(fp2_sub(v02, fp2_add(v0, v2)), v1);
    return r;
}

// multiply by v: (c0, c1, c2) -> (xi c2, c0, c1)
static inline Fp6 fp6_mul_v(const Fp6 &a) {
    return {fp2_mul_xi(a.c2), a.c0, a.c1};
}

static Fp6 fp6_inv(const Fp6 &a) {
    Fp2 t0 = fp2_sub(fp2_sqr(a.c0), fp2_mul_xi(fp2_mul(a.c1, a.c2)));
    Fp2 t1 = fp2_sub(fp2_mul_xi(fp2_sqr(a.c2)), fp2_mul(a.c0, a.c1));
    Fp2 t2 = fp2_sub(fp2_sqr(a.c1), fp2_mul(a.c0, a.c2));
    Fp2 norm = fp2_add(
        fp2_mul(a.c0, t0),
        fp2_add(fp2_mul_xi(fp2_mul(a.c2, t1)), fp2_mul_xi(fp2_mul(a.c1, t2))));
    Fp2 ninv = fp2_inv(norm);
    return {fp2_mul(t0, ninv), fp2_mul(t1, ninv), fp2_mul(t2, ninv)};
}

static Fp6 FP6_ZERO_C, FP6_ONE_C;
static Fp12 FP12_ONE_C;

static inline Fp12 fp12_mul(const Fp12 &a, const Fp12 &b) {
    Fp6 v0 = fp6_mul(a.c0, b.c0);
    Fp6 v1 = fp6_mul(a.c1, b.c1);
    Fp6 cross = fp6_mul(fp6_add(a.c0, a.c1), fp6_add(b.c0, b.c1));
    Fp12 r;
    r.c0 = fp6_add(v0, fp6_mul_v(v1));
    r.c1 = fp6_sub(cross, fp6_add(v0, v1));
    return r;
}

// complex-method squaring: 2 Fp6 products
static inline Fp12 fp12_sqr(const Fp12 &a) {
    Fp6 v0 = fp6_mul(a.c0, a.c1);
    Fp6 cross = fp6_mul(fp6_add(a.c0, a.c1), fp6_add(a.c0, fp6_mul_v(a.c1)));
    Fp12 r;
    r.c0 = fp6_sub(fp6_sub(cross, v0), fp6_mul_v(v0));
    r.c1 = fp6_add(v0, v0);
    return r;
}

static inline Fp12 fp12_conj(const Fp12 &a) { return {a.c0, fp6_neg(a.c1)}; }

static Fp12 fp12_inv(const Fp12 &a) {
    Fp6 norm = fp6_sub(fp6_mul(a.c0, a.c0), fp6_mul_v(fp6_mul(a.c1, a.c1)));
    Fp6 ninv = fp6_inv(norm);
    return {fp6_mul(a.c0, ninv), fp6_neg(fp6_mul(a.c1, ninv))};
}

static bool fp12_eq(const Fp12 &a, const Fp12 &b) {
    return fp2_eq(a.c0.c0, b.c0.c0) && fp2_eq(a.c0.c1, b.c0.c1) &&
           fp2_eq(a.c0.c2, b.c0.c2) && fp2_eq(a.c1.c0, b.c1.c0) &&
           fp2_eq(a.c1.c1, b.c1.c1) && fp2_eq(a.c1.c2, b.c1.c2);
}

// Granger-Scott squaring for unitary elements (ops/towers.py
// ::fp12_cyclo_sqr formulas; valid after the easy part only).
static Fp12 fp12_cyclo_sqr(const Fp12 &a) {
    const Fp2 &c0 = a.c0.c0, &c1 = a.c0.c1, &c2 = a.c0.c2;
    const Fp2 &c3 = a.c1.c0, &c4 = a.c1.c1, &c5 = a.c1.c2;
    Fp2 s_c4 = fp2_sqr(c4), s_c0 = fp2_sqr(c0), s_40 = fp2_sqr(fp2_add(c4, c0));
    Fp2 s_c3 = fp2_sqr(c3), s_c2 = fp2_sqr(c2), s_32 = fp2_sqr(fp2_add(c3, c2));
    Fp2 s_c5 = fp2_sqr(c5), s_c1 = fp2_sqr(c1), s_51 = fp2_sqr(fp2_add(c5, c1));
    Fp2 t6 = fp2_sub(s_40, fp2_add(s_c4, s_c0));              // 2 c0 c4
    Fp2 t7 = fp2_sub(s_32, fp2_add(s_c3, s_c2));              // 2 c2 c3
    Fp2 t8 = fp2_mul_xi(fp2_sub(s_51, fp2_add(s_c5, s_c1)));  // 2 xi c1 c5
    Fp2 t0 = fp2_add(fp2_mul_xi(s_c4), s_c0);
    Fp2 t2 = fp2_add(fp2_mul_xi(s_c2), s_c3);
    Fp2 t4 = fp2_add(fp2_mul_xi(s_c5), s_c1);
    Fp12 r;
    r.c0.c0 = fp2_add(fp2_add(fp2_sub(t0, c0), fp2_sub(t0, c0)), t0);
    r.c0.c1 = fp2_add(fp2_add(fp2_sub(t2, c1), fp2_sub(t2, c1)), t2);
    r.c0.c2 = fp2_add(fp2_add(fp2_sub(t4, c2), fp2_sub(t4, c2)), t4);
    r.c1.c0 = fp2_add(fp2_add(fp2_add(t8, c3), fp2_add(t8, c3)), t8);
    r.c1.c1 = fp2_add(fp2_add(fp2_add(t6, c4), fp2_add(t6, c4)), t6);
    r.c1.c2 = fp2_add(fp2_add(fp2_add(t7, c5), fp2_add(t7, c5)), t7);
    return r;
}

// Frobenius: gamma_k[m] = xi^(m (p^k - 1)/6); coefficient of w^i v^j is
// multiplied by gamma_k[i + 2 j] after k-fold Fp2 conjugation.
static Fp2 GAMMA1[6], GAMMA2[6];

static Fp12 fp12_frobenius(const Fp12 &a, int k) {
    const Fp2 *g = (k == 1) ? GAMMA1 : GAMMA2;
    Fp12 r;
    Fp2 t[6] = {a.c0.c0, a.c0.c1, a.c0.c2, a.c1.c0, a.c1.c1, a.c1.c2};
    if (k & 1)
        for (int i = 0; i < 6; i++) t[i] = fp2_conj(t[i]);
    // (i_w, j_v): c0 part i=0 j=0,1,2 -> m=0,2,4 ; c1 part i=1 -> m=1,3,5
    r.c0.c0 = fp2_mul(t[0], g[0]);
    r.c0.c1 = fp2_mul(t[1], g[2]);
    r.c0.c2 = fp2_mul(t[2], g[4]);
    r.c1.c0 = fp2_mul(t[3], g[1]);
    r.c1.c1 = fp2_mul(t[4], g[3]);
    r.c1.c2 = fp2_mul(t[5], g[5]);
    return r;
}

// ---------------------------------------------------------------------------
// Curve: Jacobian points over a generic field (G1: Fp, G2: Fp2)
// ---------------------------------------------------------------------------

template <class F> struct FieldOps;  // trait

template <> struct FieldOps<Fp> {
    static Fp add(const Fp &a, const Fp &b) { return fp_add(a, b); }
    static Fp sub(const Fp &a, const Fp &b) { return fp_sub(a, b); }
    static Fp mul(const Fp &a, const Fp &b) { return fp_mul(a, b); }
    static Fp sqr(const Fp &a) { return fp_sqr(a); }
    static Fp neg(const Fp &a) { return fp_neg(a); }
    static Fp inv(const Fp &a) { return fp_inv(a); }
    static bool is_zero(const Fp &a) { return fp_is_zero(a); }
    static bool eq(const Fp &a, const Fp &b) { return fp_eq(a, b); }
    static Fp zero() { return FP_ZERO; }
    static Fp one() { return FP_ONE; }
};

template <> struct FieldOps<Fp2> {
    static Fp2 add(const Fp2 &a, const Fp2 &b) { return fp2_add(a, b); }
    static Fp2 sub(const Fp2 &a, const Fp2 &b) { return fp2_sub(a, b); }
    static Fp2 mul(const Fp2 &a, const Fp2 &b) { return fp2_mul(a, b); }
    static Fp2 sqr(const Fp2 &a) { return fp2_sqr(a); }
    static Fp2 neg(const Fp2 &a) { return fp2_neg(a); }
    static Fp2 inv(const Fp2 &a) { return fp2_inv(a); }
    static bool is_zero(const Fp2 &a) { return fp2_is_zero(a); }
    static bool eq(const Fp2 &a, const Fp2 &b) { return fp2_eq(a, b); }
    static Fp2 zero() { return FP2_ZERO_C; }
    static Fp2 one() { return FP2_ONE_C; }
};

template <class F> struct Jac {
    F X, Y, Z;
    bool inf() const { return FieldOps<F>::is_zero(Z); }
};

template <class F> static Jac<F> jac_infinity() {
    return {FieldOps<F>::zero(), FieldOps<F>::one(), FieldOps<F>::zero()};
}

// dbl-2009-l (a = 0); no 2-torsion on either curve so Y != 0 for finite pts.
template <class F> static Jac<F> jac_dbl(const Jac<F> &p) {
    typedef FieldOps<F> O;
    if (p.inf()) return p;
    F A = O::sqr(p.X);
    F B = O::sqr(p.Y);
    F C = O::sqr(B);
    F t = O::sqr(O::add(p.X, B));
    F D = O::add(O::sub(O::sub(t, A), C), O::sub(O::sub(t, A), C));
    F E = O::add(O::add(A, A), A);
    F Fv = O::sqr(E);
    Jac<F> r;
    r.X = O::sub(Fv, O::add(D, D));
    F C8 = O::add(O::add(O::add(C, C), O::add(C, C)),
                  O::add(O::add(C, C), O::add(C, C)));
    r.Y = O::sub(O::mul(E, O::sub(D, r.X)), C8);
    r.Z = O::add(O::mul(p.Y, p.Z), O::mul(p.Y, p.Z));
    return r;
}

// add-2007-bl with full edge handling
template <class F> static Jac<F> jac_add(const Jac<F> &p, const Jac<F> &q) {
    typedef FieldOps<F> O;
    if (p.inf()) return q;
    if (q.inf()) return p;
    F Z1Z1 = O::sqr(p.Z);
    F Z2Z2 = O::sqr(q.Z);
    F U1 = O::mul(p.X, Z2Z2);
    F U2 = O::mul(q.X, Z1Z1);
    F S1 = O::mul(O::mul(p.Y, q.Z), Z2Z2);
    F S2 = O::mul(O::mul(q.Y, p.Z), Z1Z1);
    F H = O::sub(U2, U1);
    F rr = O::sub(S2, S1);
    if (O::is_zero(H)) {
        if (O::is_zero(rr)) return jac_dbl(p);
        return jac_infinity<F>();
    }
    rr = O::add(rr, rr);
    F I = O::sqr(O::add(H, H));
    F J = O::mul(H, I);
    F V = O::mul(U1, I);
    Jac<F> r;
    r.X = O::sub(O::sub(O::sqr(rr), J), O::add(V, V));
    F SJ = O::mul(S1, J);
    r.Y = O::sub(O::mul(rr, O::sub(V, r.X)), O::add(SJ, SJ));
    F ZZ = O::sub(O::sub(O::sqr(O::add(p.Z, q.Z)), Z1Z1), Z2Z2);
    r.Z = O::mul(ZZ, H);
    return r;
}

template <class F>
static void jac_to_affine(const Jac<F> &p, F &x, F &y, bool &is_inf) {
    typedef FieldOps<F> O;
    if (p.inf()) { is_inf = true; return; }
    is_inf = false;
    F zi = O::inv(p.Z);
    F zi2 = O::sqr(zi);
    x = O::mul(p.X, zi2);
    y = O::mul(O::mul(p.Y, zi2), zi);
}

// double-and-add, MSB-first over an arbitrary-length big-endian scalar
// (scalars are NOT reduced — cofactor clearing passes huge ones;
// mirrors ref/curve.py::CurveOps.mul).
template <class F>
static Jac<F> jac_mul(const F &ax, const F &ay, bool a_inf, const uint8_t *sc,
                      int sclen) {
    Jac<F> acc = jac_infinity<F>();
    if (a_inf) return acc;
    Jac<F> base = {ax, ay, FieldOps<F>::one()};
    bool started = false;
    for (int i = 0; i < sclen; i++) {
        for (int b = 7; b >= 0; b--) {
            if (started) acc = jac_dbl(acc);
            if ((sc[i] >> b) & 1) {
                if (!started) { acc = base; started = true; }
                else acc = jac_add(acc, base);
            }
        }
    }
    return acc;
}

// ---------------------------------------------------------------------------
// Pairing: twist-Jacobian Miller loop + x-chain final exponentiation
// (same algorithm as ref/pairing.py::miller_loop_projective and
// ops/pairing.py::final_exponentiation — identical GT outputs)
// ---------------------------------------------------------------------------

static const u64 ABS_X = 0xd201000000010000ULL;  // |x|, x < 0

static Fp2 B_G2_MONT;  // 4(u+1)
static Fp B_G1_MONT;   // 4

// line = c_v2 v^2 + c_w w + c_wv (w v) as a dense Fp12
static inline Fp12 sparse_line(const Fp2 &c_v2, const Fp2 &c_w,
                               const Fp2 &c_wv) {
    Fp12 r;
    r.c0 = {FP2_ZERO_C, FP2_ZERO_C, c_v2};
    r.c1 = {c_w, c_wv, FP2_ZERO_C};
    return r;
}

// f * (c_v2 v^2 + c_w w + c_wv w v) exploiting the sparsity: the dense
// Karatsuba-2 runs 18 Fp2 muls, this runs 13.
static Fp12 fp12_mul_sparse(const Fp12 &f, const Fp2 &c_v2, const Fp2 &c_w,
                            const Fp2 &c_wv) {
    // s0 = (0, 0, c_v2): a*s0 = (xi(a1 c_v2), xi(a2 c_v2), a0 c_v2)
    const Fp6 &a0 = f.c0, &a1 = f.c1;
    Fp6 v0 = {fp2_mul_xi(fp2_mul(a0.c1, c_v2)),
              fp2_mul_xi(fp2_mul(a0.c2, c_v2)), fp2_mul(a0.c0, c_v2)};
    // s1 = (c_w, c_wv, 0): b2 = 0 term drops out of the schoolbook form
    Fp6 v1 = {fp2_add(fp2_mul(a1.c0, c_w),
                      fp2_mul_xi(fp2_mul(a1.c2, c_wv))),
              fp2_add(fp2_mul(a1.c0, c_wv), fp2_mul(a1.c1, c_w)),
              fp2_add(fp2_mul(a1.c1, c_wv), fp2_mul(a1.c2, c_w))};
    // cross = (a0 + a1) * (s0 + s1), s0+s1 = (c_w, c_wv, c_v2)
    Fp6 s = fp6_add(a0, a1);
    Fp6 cross = {
        fp2_add(fp2_mul(s.c0, c_w),
                fp2_mul_xi(fp2_add(fp2_mul(s.c1, c_v2), fp2_mul(s.c2, c_wv)))),
        fp2_add(fp2_add(fp2_mul(s.c0, c_wv), fp2_mul(s.c1, c_w)),
                fp2_mul_xi(fp2_mul(s.c2, c_v2))),
        fp2_add(fp2_add(fp2_mul(s.c0, c_v2), fp2_mul(s.c1, c_wv)),
                fp2_mul(s.c2, c_w))};
    Fp12 r;
    r.c0 = fp6_add(v0, fp6_mul_v(v1));
    r.c1 = fp6_sub(cross, fp6_add(v0, v1));
    return r;
}

struct G2Jac {
    Fp2 x, y, z;
};

// ref/pairing.py dbl: line coeffs then dbl-2009-l on the twist
static void miller_dbl(G2Jac &t, const Fp &xp, const Fp &yp, Fp2 &c_v2,
                       Fp2 &c_w, Fp2 &c_wv) {
    Fp2 zsq = fp2_sqr(t.z);
    Fp2 z3 = fp2_mul(zsq, t.z);
    Fp2 xsq = fp2_sqr(t.x);
    Fp2 ysq = fp2_sqr(t.y);
    c_v2 = fp2_scale(fp2_mul(t.y, z3), fp_dbl(yp));
    Fp2 x3p = fp2_mul(xsq, t.x);
    c_w = fp2_sub(fp2_add(fp2_add(x3p, x3p), x3p), fp2_dbl(ysq));
    Fp2 xz = fp2_mul(xsq, zsq);
    c_wv = fp2_neg(fp2_scale(fp2_add(fp2_add(xz, xz), xz), xp));
    // dbl-2009-l
    Fp2 a = xsq, b = ysq;
    Fp2 c = fp2_sqr(b);
    Fp2 d = fp2_dbl(fp2_sub(fp2_sub(fp2_sqr(fp2_add(t.x, b)), a), c));
    Fp2 e = fp2_add(fp2_add(a, a), a);
    Fp2 f = fp2_sqr(e);
    Fp2 x3 = fp2_sub(f, fp2_dbl(d));
    Fp2 c8 = fp2_dbl(fp2_dbl(fp2_dbl(c)));
    Fp2 y3 = fp2_sub(fp2_mul(e, fp2_sub(d, x3)), c8);
    Fp2 z3_ = fp2_dbl(fp2_mul(t.y, t.z));
    t = {x3, y3, z3_};
}

// ref/pairing.py add: chord line then madd-2007-bl (Z2 = 1)
static void miller_add(G2Jac &t, const Fp2 &xq, const Fp2 &yq, const Fp &xp,
                       const Fp &yp, Fp2 &c_v2, Fp2 &c_w, Fp2 &c_wv) {
    Fp2 zsq = fp2_sqr(t.z);
    Fp2 z3 = fp2_mul(zsq, t.z);
    Fp2 num = fp2_sub(t.y, fp2_mul(yq, z3));            // Y - yq Z^3
    Fp2 den = fp2_mul(t.z, fp2_sub(t.x, fp2_mul(xq, zsq)));  // Z(X - xq Z^2)
    c_v2 = fp2_scale(den, yp);
    c_wv = fp2_neg(fp2_scale(num, xp));
    c_w = fp2_sub(fp2_mul(xq, num), fp2_mul(yq, den));
    // madd-2007-bl
    Fp2 u2 = fp2_mul(xq, zsq);
    Fp2 s2 = fp2_mul(yq, z3);
    Fp2 h = fp2_sub(u2, t.x);
    Fp2 r = fp2_dbl(fp2_sub(s2, t.y));
    Fp2 i = fp2_sqr(fp2_dbl(h));
    Fp2 j = fp2_mul(h, i);
    Fp2 v = fp2_mul(t.x, i);
    Fp2 x3 = fp2_sub(fp2_sub(fp2_sqr(r), j), fp2_dbl(v));
    Fp2 y3 = fp2_sub(fp2_mul(r, fp2_sub(v, x3)), fp2_dbl(fp2_mul(t.y, j)));
    Fp2 z3_ = fp2_sub(fp2_sub(fp2_sqr(fp2_add(t.z, h)), zsq), fp2_sqr(h));
    t = {x3, y3, z3_};
}

// f_{|x|,Q}(P), conjugated for x < 0; affine finite inputs.
static Fp12 miller_loop(const Fp &xp, const Fp &yp, const Fp2 &xq,
                        const Fp2 &yq) {
    Fp12 f = FP12_ONE_C;
    G2Jac t = {xq, yq, FP2_ONE_C};
    Fp2 c_v2, c_w, c_wv;
    // MSB of |x| consumed by the initial T = Q; iterate remaining 63 bits
    for (int b = 62; b >= 0; b--) {
        miller_dbl(t, xp, yp, c_v2, c_w, c_wv);
        f = fp12_mul_sparse(fp12_sqr(f), c_v2, c_w, c_wv);
        if ((ABS_X >> b) & 1) {
            miller_add(t, xq, yq, xp, yp, c_v2, c_w, c_wv);
            f = fp12_mul_sparse(f, c_v2, c_w, c_wv);
        }
    }
    return fp12_conj(f);
}

// a^e (64-bit static exponent) with cyclotomic squarings; unitary a only.
static Fp12 cyclo_pow(const Fp12 &a, u64 e) {
    Fp12 acc = a;
    int top = 63;
    while (top >= 0 && !((e >> top) & 1)) top--;
    for (int b = top - 1; b >= 0; b--) {
        acc = fp12_cyclo_sqr(acc);
        if ((e >> b) & 1) acc = fp12_mul(acc, a);
    }
    return acc;
}

// f^(3 (p^12-1)/r): the framework's canonical (cubed) pairing power.
// Chain identical to ops/pairing.py::final_exponentiation.
static Fp12 final_exponentiation(const Fp12 &f) {
    Fp12 f1 = fp12_mul(fp12_conj(f), fp12_inv(f));       // ^(p^6 - 1)
    Fp12 f2 = fp12_mul(fp12_frobenius(f1, 2), f1);       // ^(p^2 + 1)
    Fp12 m1 = fp12_conj(cyclo_pow(f2, ABS_X + 1));       // f2^(x-1)
    Fp12 m2 = fp12_conj(cyclo_pow(m1, ABS_X + 1));       // ^(x-1)^2
    Fp12 m3 = fp12_mul(fp12_conj(cyclo_pow(m2, ABS_X)), fp12_frobenius(m2, 1));
    Fp12 m3x2 = cyclo_pow(cyclo_pow(m3, ABS_X), ABS_X);  // conj x2 cancels
    Fp12 m4 =
        fp12_mul(fp12_mul(m3x2, fp12_frobenius(m3, 2)), fp12_conj(m3));
    return fp12_mul(m4, fp12_mul(fp12_sqr(f2), f2));     // * f2^3
}

// ---------------------------------------------------------------------------
// init
// ---------------------------------------------------------------------------

static bool INIT_DONE = false;

static void init_constants() {
    if (INIT_DONE) return;
    // NP = -p^-1 mod 2^64 via Newton iteration
    u64 inv = P_LIMBS[0];
    for (int i = 0; i < 5; i++) inv *= 2 - P_LIMBS[0] * inv;
    NP = (u64)(0 - inv);
    memset(FP_ZERO.v, 0, sizeof FP_ZERO.v);
    // R mod p by doubling canonical 1, 384 times; then R^2 by 768
    u64 acc[6] = {1, 0, 0, 0, 0, 0};
    for (int i = 0; i < 768; i++) {
        u64 carry = limbs_add(acc, acc, acc);
        if (carry || limbs_ge(acc, P_LIMBS)) limbs_sub(acc, acc, P_LIMBS);
        if (i == 383) memcpy(FP_ONE.v, acc, sizeof FP_ONE.v);  // R mod p
    }
    memcpy(FP_R2.v, acc, sizeof FP_R2.v);
    memcpy(R2_LIMBS, acc, sizeof R2_LIMBS);
    // exponents: p-2, (p+1)/4, (p-1)/2
    u64 two[6] = {2, 0, 0, 0, 0, 0};
    limbs_sub(PM2, P_LIMBS, two);
    u64 pp1[6];
    u64 one1[6] = {1, 0, 0, 0, 0, 0};
    limbs_add(pp1, P_LIMBS, one1);  // p odd: no carry out of 381 bits
    for (int s = 0; s < 2; s++) {   // >> 2
        u64 carry = 0;
        for (int i = 5; i >= 0; i--) {
            u64 nc = pp1[i] & 1;
            pp1[i] = (pp1[i] >> 1) | (carry << 63);
            carry = nc;
        }
    }
    memcpy(PP14, pp1, sizeof PP14);
    u64 pm1[6];
    limbs_sub(pm1, P_LIMBS, one1);
    u64 carry = 0;
    for (int i = 5; i >= 0; i--) {
        u64 nc = pm1[i] & 1;
        pm1[i] = (pm1[i] >> 1) | (carry << 63);
        carry = nc;
    }
    memcpy(PM12, pm1, sizeof PM12);
    // tower constants
    FP2_ZERO_C = {FP_ZERO, FP_ZERO};
    FP2_ONE_C = {FP_ONE, FP_ZERO};
    FP6_ZERO_C = {FP2_ZERO_C, FP2_ZERO_C, FP2_ZERO_C};
    FP6_ONE_C = {FP2_ONE_C, FP2_ZERO_C, FP2_ZERO_C};
    FP12_ONE_C = {FP6_ONE_C, FP6_ZERO_C};
    FP_INV2 = fp_inv(fp_add(FP_ONE, FP_ONE));
    B_G1_MONT = fp_dbl(fp_dbl(FP_ONE));                    // 4
    B_G2_MONT = {B_G1_MONT, B_G1_MONT};                    // 4(u+1)
    // Frobenius gammas: gamma1[m] = xi^(m (p-1)/6)
    u64 e6[6];
    limbs_sub(e6, P_LIMBS, one1);  // p - 1
    u128 rem = 0;
    for (int i = 5; i >= 0; i--) {  // divide by 6
        u128 cur = (rem << 64) | e6[i];
        e6[i] = (u64)(cur / 6);
        rem = cur % 6;
    }
    Fp2 xi = {FP_ONE, FP_ONE};
    Fp2 g1 = fp2_pow_limbs(xi, e6, 6);
    GAMMA1[0] = FP2_ONE_C;
    for (int m = 1; m < 6; m++) GAMMA1[m] = fp2_mul(GAMMA1[m - 1], g1);
    for (int m = 0; m < 6; m++) GAMMA2[m] = fp2_mul(GAMMA1[m], fp2_conj(GAMMA1[m]));
    INIT_DONE = true;
}

// ---------------------------------------------------------------------------
// byte helpers for the ABI
// ---------------------------------------------------------------------------

static Fp2 fp2_from_bytes(const uint8_t *b) {
    return {fp_from_bytes(b), fp_from_bytes(b + 48)};
}

static void fp2_to_bytes(const Fp2 &a, uint8_t *out) {
    fp_to_bytes(a.c0, out);
    fp_to_bytes(a.c1, out + 48);
}

static void fp12_to_bytes(const Fp12 &a, uint8_t *out) {
    const Fp2 *cs[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2,
                        &a.c1.c0, &a.c1.c1, &a.c1.c2};
    for (int i = 0; i < 6; i++) fp2_to_bytes(*cs[i], out + 96 * i);
}

// ---------------------------------------------------------------------------
// exported ABI
// ---------------------------------------------------------------------------

extern "C" {

// init + algebraic selftest; returns 1 when healthy.
int hbls_ready() {
    init_constants();
    // deterministic element: a = (to_mont bytes of small ints)
    Fp12 a;
    Fp2 *cs[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2, &a.c1.c0, &a.c1.c1, &a.c1.c2};
    for (int i = 0; i < 6; i++) {
        Fp x = FP_ONE;
        for (int j = 0; j < i + 2; j++) x = fp_add(x, FP_ONE);
        *cs[i] = {x, fp_add(x, FP_ONE)};
    }
    // a * a^-1 == 1
    if (!fp12_eq(fp12_mul(a, fp12_inv(a)), FP12_ONE_C)) return -1;
    // frob(frob(a,1),1) == frob(a,2)
    if (!fp12_eq(fp12_frobenius(fp12_frobenius(a, 1), 1), fp12_frobenius(a, 2)))
        return -2;
    // cyclo_sqr == sqr in the cyclotomic subgroup (full easy part:
    // unitary alone is NOT enough for Granger-Scott)
    Fp12 u = fp12_mul(fp12_conj(a), fp12_inv(a));      // ^(p^6 - 1)
    u = fp12_mul(fp12_frobenius(u, 2), u);             // ^(p^2 + 1)
    if (!fp12_eq(fp12_cyclo_sqr(u), fp12_sqr(u))) return -3;
    return 1;
}

// scalar mul: out-affine; returns 1 if result is infinity.
int hbls_g1_mul(const uint8_t *xy, int inf, const uint8_t *sc, int sclen,
                uint8_t *out) {
    init_constants();
    Fp x = inf ? FP_ZERO : fp_from_bytes(xy);
    Fp y = inf ? FP_ZERO : fp_from_bytes(xy + 48);
    Jac<Fp> r = jac_mul<Fp>(x, y, inf != 0, sc, sclen);
    bool is_inf;
    Fp rx, ry;
    jac_to_affine(r, rx, ry, is_inf);
    if (is_inf) { memset(out, 0, 96); return 1; }
    fp_to_bytes(rx, out);
    fp_to_bytes(ry, out + 48);
    return 0;
}

int hbls_g2_mul(const uint8_t *xy, int inf, const uint8_t *sc, int sclen,
                uint8_t *out) {
    init_constants();
    Fp2 x = inf ? FP2_ZERO_C : fp2_from_bytes(xy);
    Fp2 y = inf ? FP2_ZERO_C : fp2_from_bytes(xy + 96);
    Jac<Fp2> r = jac_mul<Fp2>(x, y, inf != 0, sc, sclen);
    bool is_inf;
    Fp2 rx, ry;
    jac_to_affine(r, rx, ry, is_inf);
    if (is_inf) { memset(out, 0, 192); return 1; }
    fp2_to_bytes(rx, out);
    fp2_to_bytes(ry, out + 96);
    return 0;
}

// sum of n affine points (aggregation); returns 1 if infinity.
int hbls_g1_sum(const uint8_t *pts, const uint8_t *infs, int n, uint8_t *out) {
    init_constants();
    Jac<Fp> acc = jac_infinity<Fp>();
    for (int i = 0; i < n; i++) {
        if (infs[i]) continue;
        Jac<Fp> p = {fp_from_bytes(pts + 96 * i),
                     fp_from_bytes(pts + 96 * i + 48), FP_ONE};
        acc = jac_add(acc, p);
    }
    bool is_inf;
    Fp rx, ry;
    jac_to_affine(acc, rx, ry, is_inf);
    if (is_inf) { memset(out, 0, 96); return 1; }
    fp_to_bytes(rx, out);
    fp_to_bytes(ry, out + 48);
    return 0;
}

int hbls_g2_sum(const uint8_t *pts, const uint8_t *infs, int n, uint8_t *out) {
    init_constants();
    Jac<Fp2> acc = jac_infinity<Fp2>();
    for (int i = 0; i < n; i++) {
        if (infs[i]) continue;
        Jac<Fp2> p = {fp2_from_bytes(pts + 192 * i),
                      fp2_from_bytes(pts + 192 * i + 96), FP2_ONE_C};
        acc = jac_add(acc, p);
    }
    bool is_inf;
    Fp2 rx, ry;
    jac_to_affine(acc, rx, ry, is_inf);
    if (is_inf) { memset(out, 0, 192); return 1; }
    fp2_to_bytes(rx, out);
    fp2_to_bytes(ry, out + 96);
    return 0;
}

// subgroup membership: r * P == infinity (rogue-point defense used by
// decompress; the affine Python version costs ~40 ms, this ~0.3 ms).
int hbls_g1_in_subgroup(const uint8_t *xy, const uint8_t *r_be, int rlen) {
    init_constants();
    Fp x = fp_from_bytes(xy), y = fp_from_bytes(xy + 48);
    // must be on curve first: y^2 == x^3 + 4
    Fp lhs = fp_sqr(y);
    Fp rhs = fp_add(fp_mul(fp_sqr(x), x), B_G1_MONT);
    if (!fp_eq(lhs, rhs)) return 0;
    Jac<Fp> p = jac_mul<Fp>(x, y, false, r_be, rlen);
    return p.inf() ? 1 : 0;
}

int hbls_g2_in_subgroup(const uint8_t *xy, const uint8_t *r_be, int rlen) {
    init_constants();
    Fp2 x = fp2_from_bytes(xy), y = fp2_from_bytes(xy + 96);
    Fp2 lhs = fp2_sqr(y);
    Fp2 rhs = fp2_add(fp2_mul(fp2_sqr(x), x), B_G2_MONT);
    if (!fp2_eq(lhs, rhs)) return 0;
    Jac<Fp2> p = jac_mul<Fp2>(x, y, false, r_be, rlen);
    return p.inf() ? 1 : 0;
}

// try-and-increment map step (ref/hash_to_curve.py::map_to_twist body):
// given candidate x in Fp2, find y with y^2 = x^3 + 4(u+1), pick the
// lexicographically smaller of {y, -y}.  Returns 1 on success.
int hbls_g2_map_tai(const uint8_t *x96, uint8_t *out192) {
    init_constants();
    Fp2 x = fp2_from_bytes(x96);
    Fp2 rhs = fp2_add(fp2_mul(fp2_sqr(x), x), B_G2_MONT);
    Fp2 y;
    if (!fp2_sqrt(rhs, y)) return 0;
    Fp2 ny = fp2_neg(y);
    if (fp2_lex_gt(y, ny)) y = ny;
    fp2_to_bytes(x, out192);
    fp2_to_bytes(y, out192 + 96);
    return 1;
}

// deterministic Fp2 sqrt (decompress path); returns 1 on success.
int hbls_fp2_sqrt(const uint8_t *in96, uint8_t *out96) {
    init_constants();
    Fp2 a = fp2_from_bytes(in96);
    Fp2 r;
    if (!fp2_sqrt(a, r)) return 0;
    fp2_to_bytes(r, out96);
    return 1;
}

int hbls_fp_sqrt(const uint8_t *in48, uint8_t *out48) {
    init_constants();
    Fp a = fp_from_bytes(in48);
    bool ok;
    Fp r = fp_sqrt(a, ok);
    if (!ok) return 0;
    fp_to_bytes(r, out48);
    return 1;
}

// prod_i e(P_i, Q_i) as a full GT element (576 B, ref tuple order) —
// the parity surface the tests pin against ref/pairing.py.
void hbls_multi_pairing(const uint8_t *g1s, const uint8_t *g1infs,
                        const uint8_t *g2s, const uint8_t *g2infs, int n,
                        uint8_t *out576) {
    init_constants();
    Fp12 f = FP12_ONE_C;
    for (int i = 0; i < n; i++) {
        if (g1infs[i] || g2infs[i]) continue;  // e(O, Q) = 1
        Fp xp = fp_from_bytes(g1s + 96 * i);
        Fp yp = fp_from_bytes(g1s + 96 * i + 48);
        Fp2 xq = fp2_from_bytes(g2s + 192 * i);
        Fp2 yq = fp2_from_bytes(g2s + 192 * i + 96);
        f = fp12_mul(f, miller_loop(xp, yp, xq, yq));
    }
    fp12_to_bytes(final_exponentiation(f), out576);
}

// prod_i e(P_i, Q_i) == 1 — the verify decision (2 pairs for a single
// check, 2B for a replay batch with shared final exponentiation).
int hbls_pairing_check(const uint8_t *g1s, const uint8_t *g1infs,
                       const uint8_t *g2s, const uint8_t *g2infs, int n) {
    init_constants();
    Fp12 f = FP12_ONE_C;
    for (int i = 0; i < n; i++) {
        if (g1infs[i] || g2infs[i]) continue;
        Fp xp = fp_from_bytes(g1s + 96 * i);
        Fp yp = fp_from_bytes(g1s + 96 * i + 48);
        Fp2 xq = fp2_from_bytes(g2s + 192 * i);
        Fp2 yq = fp2_from_bytes(g2s + 192 * i + 96);
        f = fp12_mul(f, miller_loop(xp, yp, xq, yq));
    }
    return fp12_eq(final_exponentiation(f), FP12_ONE_C) ? 1 : 0;
}

}  // extern "C"
