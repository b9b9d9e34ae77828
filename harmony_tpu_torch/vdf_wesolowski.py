"""Wesolowski VDF over class groups of imaginary quadratic fields.

The reference's production randomness beacon consumes the external
harmony-one/vdf library (reference: go.mod:29, used at
consensus/consensus_v2.go:955-1034; mainnet difficulty 50000,
internal/configs/sharding/mainnet.go:20) — a class-group VDF in the
style of the Chia competition entries.  This module implements the
same construction from first principles:

* the group: reduced positive-definite binary quadratic forms
  (a, b, c), b^2 - 4ac = D < 0, composed by Gauss/Cohen composition
  (Cohen, *A Course in Computational Algebraic Number Theory*,
  Alg. 5.4.7) — sequential squaring here is the delay;
* the discriminant: derived from the seed by keccak expansion to a
  prime p = 7 (mod 8), D = -p (so (2, 1, (1-D)/8) generates);
* the proof: Wesolowski's succinct argument — l = HashPrime(g, y),
  pi = g^(2^T / l) computed alongside the squaring chain by the
  on-the-fly long-division trick, verified as pi^l * g^(2^T mod l) == y
  in two small exponentiations instead of T squarings.

Sequentiality is the point: this stays on the host CPU (SURVEY §2.1:
CPU-bound sequential, not accelerator work); the card's budget belongs
to the BLS checks.  The sha3-chain PoC twin lives in vdf.py (the reference also
carries its own PoC at crypto/vdf/vdf.go:10-47).

The port's copy of the JAX package's ``vdf_wesolowski.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import gcd

from .ref.keccak import keccak256

# -- primality ---------------------------------------------------------------

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47]


def is_probable_prime(n: int, rounds: int = 30) -> bool:
    """Deterministic-enough Miller-Rabin (derandomized bases from the
    number itself; 2^-60 error floor is far below the keccak collision
    budget this feeds)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    seed = n.to_bytes((n.bit_length() + 7) // 8, "big")
    for i in range(rounds):
        a = int.from_bytes(
            keccak256(seed + bytes([i])), "big"
        ) % (n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _keccak_expand(seed: bytes, bits: int) -> int:
    out = b""
    ctr = 0
    while len(out) * 8 < bits:
        out += keccak256(seed + ctr.to_bytes(4, "big"))
        ctr += 1
    v = int.from_bytes(out, "big") >> (len(out) * 8 - bits)
    return v | (1 << (bits - 1))  # full bit length


def create_discriminant(seed: bytes, bits: int = 2048) -> int:
    """D = -p, p the first probable prime = 7 (mod 8) at/after the
    keccak expansion of the seed (the harmony-one/vdf library's
    CreateDiscriminant contract: seed -> canonical negative prime
    discriminant)."""
    n = _keccak_expand(seed, bits)
    n += (7 - n) % 8  # = 7 (mod 8)
    while not is_probable_prime(n):
        n += 8
    return -n


# -- the class group ---------------------------------------------------------


def _xgcd(a: int, b: int):
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t


@dataclass(frozen=True)
class Form:
    """A positive-definite binary quadratic form ax^2 + bxy + cy^2."""

    a: int
    b: int
    c: int

    @property
    def discriminant(self) -> int:
        return self.b * self.b - 4 * self.a * self.c

    # -- reduction ----------------------------------------------------------

    def _normalized(self) -> "Form":
        a, b, c = self.a, self.b, self.c
        if -a < b <= a:
            return self
        r = (a - b) // (2 * a)
        return Form(a, b + 2 * r * a, a * r * r + b * r + c)

    def reduced(self) -> "Form":
        f = self._normalized()
        a, b, c = f.a, f.b, f.c
        while a > c or (a == c and b < 0):
            s = (c + b) // (2 * c)
            a, b, c = c, -b + 2 * s * c, c * s * s - b * s + a
        return Form(a, b, c)._normalized()

    # -- composition (Cohen Alg. 5.4.7) -------------------------------------

    def compose(self, other: "Form") -> "Form":
        D = self.discriminant
        f1, f2 = (other, self) if self.a > other.a else (self, other)
        a1, b1, c1 = f1.a, f1.b, f1.c
        a2, b2, c2 = f2.a, f2.b, f2.c
        s = (b1 + b2) // 2
        n = b2 - s
        if a2 % a1 == 0:
            y1, d = 0, a1
        else:
            d, u, _v = _xgcd(a2, a1)
            y1 = u
        if s % d == 0:
            y2, x2, d1 = -1, 0, d
        else:
            d1, u2, v2 = _xgcd(s, d)
            x2, y2 = u2, -v2
        v1 = a1 // d1
        v2_ = a2 // d1
        r = (y1 * y2 * n - x2 * c2) % v1
        b3 = b2 + 2 * v2_ * r
        a3 = v1 * v2_
        c3 = (b3 * b3 - D) // (4 * a3)
        return Form(a3, b3, c3).reduced()

    def square(self) -> "Form":
        return self.compose(self)

    def pow(self, e: int) -> "Form":
        result = identity(self.discriminant)
        base = self
        while e > 0:
            if e & 1:
                result = result.compose(base)
            base = base.square()
            e >>= 1
        return result

    # -- serialization (a then b, signed big-endian, length-prefixed) -------

    def serialize(self) -> bytes:
        def enc(v: int) -> bytes:
            raw = v.to_bytes(
                (v.bit_length() + 8) // 8, "big", signed=True
            )
            return len(raw).to_bytes(2, "big") + raw

        return enc(self.a) + enc(self.b)

    @classmethod
    def deserialize(cls, data: bytes, D: int) -> "Form":
        def dec(buf, off):
            ln = int.from_bytes(buf[off:off + 2], "big")
            v = int.from_bytes(
                buf[off + 2:off + 2 + ln], "big", signed=True
            )
            return v, off + 2 + ln

        a, off = dec(data, 0)
        b, off = dec(data, off)
        if a <= 0:
            raise ValueError("form a-coefficient must be positive")
        num = b * b - D
        if num % (4 * a):
            raise ValueError("(a, b) not on the discriminant")
        return cls(a, b, num // (4 * a))


def identity(D: int) -> Form:
    return Form(1, 1, (1 - D) // 4)


def generator(D: int) -> Form:
    """(2, 1, (1-D)/8): a principal-genus non-identity form; requires
    D = 1 (mod 8), guaranteed by create_discriminant."""
    return Form(2, 1, (1 - D) // 8).reduced()


# -- Wesolowski evaluate / verify -------------------------------------------


def hash_prime(data: bytes, bits: int = 128) -> int:
    """The Fiat-Shamir challenge prime l."""
    ctr = 0
    while True:
        n = _keccak_expand(data + ctr.to_bytes(4, "big"), bits) | 1
        if is_probable_prime(n):
            return n
        ctr += 1


@dataclass
class WesolowskiProof:
    y: Form    # g^(2^T)
    pi: Form   # g^floor(2^T / l)


class WesolowskiVDF:
    """evaluate(seed) -> (output_bytes, proof); verify in O(log T)."""

    def __init__(self, difficulty: int, discriminant_bits: int = 512):
        if difficulty < 1:
            raise ValueError("difficulty must be >= 1")
        self.difficulty = difficulty
        self.discriminant_bits = discriminant_bits

    def _challenge(self, D: int, g: Form, y: Form) -> int:
        return hash_prime(
            D.to_bytes((abs(D).bit_length() + 15) // 8, "big", signed=True)
            + g.serialize() + y.serialize()
        )

    def evaluate(self, seed: bytes):
        """T sequential squarings, with the proof accumulated by long
        division: pi = prod over steps of g^{bit}, squared along —
        Wesolowski's two-pass trick collapsed into the one sequential
        pass (the second pass costs the same T squarings again, which
        is the accepted cost of proving)."""
        D = create_discriminant(seed, self.discriminant_bits)
        g = generator(D)
        T = self.difficulty
        y = g
        for _ in range(T):
            y = y.square()
        l = self._challenge(D, g, y)
        # pi = g^floor(2^T / l) via left-to-right long division
        pi = identity(D)
        r = 1
        for _ in range(T):
            b, r = divmod(2 * r, l)
            pi = pi.square()
            if b:
                pi = pi.compose(g)
        return y.serialize(), WesolowskiProof(y, pi)

    def verify(self, seed: bytes, output: bytes,
               proof: WesolowskiProof) -> bool:
        D = create_discriminant(seed, self.discriminant_bits)
        g = generator(D)
        try:
            y = Form.deserialize(output, D)
        except ValueError:
            return False
        if y != proof.y.reduced():
            return False
        l = self._challenge(D, g, y)
        r = pow(2, self.difficulty, l)
        return proof.pi.pow(l).compose(g.pow(r)) == y.reduced()
