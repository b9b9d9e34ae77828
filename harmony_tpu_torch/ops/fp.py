"""Batched 381-bit Fp arithmetic in PyTorch: the substrate of the port.

The same arithmetic as the JAX package's ops/fp.py, limb for limb:

- 32 limbs x 12 bits in int32 (ops/limbs.py): every partial product
  stays < 2^24 and every lazy accumulator < 2^31.
- Additions and subtractions resolve carries and borrows by a
  Kogge-Stone lookahead over (generate, propagate) pairs along the limb
  axis.
- ``mont_mul``, ``add``, ``sub``, ``neg`` and ``inv`` dispatch on their
  tensors' device.  For a CUDA tensor each launches a hand-written kernel
  (kernels/mont_mul.py, kernels/fp_addsub.py, kernels/fp_inv.py); for a
  CPU tensor it runs its plain PyTorch version (``mont_mul_reference``,
  the 32-step shift-based CIOS; ``add_reference``, ``sub_reference``,
  ``neg_reference``; ``inv_reference``, the Fermat chain of products).
  Nothing selects a plain version for a tensor on the card.

All functions are shape-polymorphic over leading batch axes and run on
the device of their inputs; tower fields (ops/towers.py) stack their
independent sub-products into one call (54 Fp products per Fp12 product
in the plain composition; on the card the Fp12 operations are fused
kernels of their own).
"""

import torch

from ..kernels import fp_addsub as K_ADDSUB
from ..kernels import fp_inv as K_INV
from ..kernels import mont_mul as K_MUL
from . import _constants as C
from .limbs import LIMB_BITS, LIMB_MASK, N_LIMBS, int_to_limbs

P_LIMBS = torch.from_numpy(int_to_limbs(C.P_INT))
ONE_MONT = torch.tensor(C.ONE_MONT, dtype=torch.int32)
R2 = torch.tensor(C.R2_LIMBS, dtype=torch.int32)
_ONE_RAW = torch.from_numpy(int_to_limbs(1))

_P_INV_NEG = C.P_INV_NEG

# exponent bits (MSB first) for fixed-exponent powering
_P_MINUS_2_BITS = tuple(int(b) for b in bin(C.P_INT - 2)[2:])

# 2 * limb position, 1-based: the running-maximum key of _carry_out
_POS2 = 2 * torch.arange(1, N_LIMBS + 1, dtype=torch.int32)

_ON_DEVICE: dict = {}


def on_device(const: torch.Tensor, device) -> torch.Tensor:
    """A module constant on ``device``: copied once per (constant, device)
    and reused, so no hot-path call pays a host-to-device copy."""
    device = torch.device(device)
    if device.type == "cpu":
        return const
    key = (id(const), device)
    out = _ON_DEVICE.get(key)
    if out is None:
        out = _ON_DEVICE.setdefault(key, const.to(device))
    return out


def _shift_in_zeros(x, d):
    """x shifted up by d along the last axis, zeros shifted in at the front."""
    return torch.constant_pad_nd(x, (d, -d))


def _carry_out(gen, decides):
    """Inclusive prefix carries along the last axis: the carry OUT of
    each limb.

    ``decides`` marks the limbs whose carry-out does not depend on the
    carry coming in (they generate one, gen = 1, or kill it); elsewhere
    the limb propagates.  The carry out of limb i is gen_j at the last
    deciding limb j <= i, and 0 where none has decided yet.  A running
    maximum over (2 * position + gen) finds that limb and its gen bit at
    once: the carries of the JAX package's Kogge-Stone lookahead, in 4
    tensor ops instead of 25.
    """
    key = torch.where(decides, on_device(_POS2, gen.device) + gen, 0)
    return torch.cummax(key, dim=-1).values & 1


def _lookahead(gen, decides):
    """Exclusive prefix carries: the carry INTO each limb."""
    return _shift_in_zeros(_carry_out(gen, decides), 1)


def resolve_carries(s):
    """Exact digit normalization for limbs in [0, 2^13 - 1]: one
    carry-lookahead pass (carries are binary in this range).

    A limb generates a carry when s >= 2^12 and propagates one when its
    low 12 bits are all ones, so only s == 2^12 - 1 leaves the carry
    undecided."""
    carry_in = _lookahead(s >> LIMB_BITS, s != LIMB_MASK)
    return (s + carry_in) & LIMB_MASK


def normalize(t):
    """Exact digits from lazy nonneg limbs < 2^31 (value must be < 2^384).

    Three value-halving rounds shrink carries to binary, then one
    lookahead pass finishes exactly.
    """
    for _ in range(3):
        q = t >> LIMB_BITS
        rem = t & LIMB_MASK
        t = rem + _shift_in_zeros(q, 1)
    return resolve_carries(t)


def _sub_exact(x, y):
    """(x - y) as exact digits plus the final borrow (1 iff x < y).

    x, y must be canonical digit arrays.  A limb difference d generates a
    borrow when d < 0 and propagates one when d == 0.
    """
    d = x - y
    borrow_out = _carry_out(d < 0, d != 0)
    out = (d - _shift_in_zeros(borrow_out, 1)) & LIMB_MASK
    return out, borrow_out[..., -1]


def cond_sub_p(a):
    """Map canonical digits with value in [0, 2p) to [0, p)."""
    diff, borrow = _sub_exact(a, on_device(P_LIMBS, a.device))
    return torch.where(borrow[..., None] == 1, a, diff)


def add(a, b):
    """Canonical modular addition: the kernel for CUDA tensors, the plain
    version for CPU tensors (the same dispatch as ``mont_mul``)."""
    if a.is_cpu and b.is_cpu:
        return add_reference(a, b)
    return K_ADDSUB.add(a, b)


def sub(a, b):
    """Canonical modular subtraction, dispatched as ``add``."""
    if a.is_cpu and b.is_cpu:
        return sub_reference(a, b)
    return K_ADDSUB.sub(a, b)


def neg(a):
    """Canonical modular negation (-0 = 0), dispatched as ``add``."""
    if a.is_cpu:
        return neg_reference(a)
    return K_ADDSUB.neg(a)


def add_reference(a, b):
    """The plain PyTorch modular addition."""
    return cond_sub_p(resolve_carries(a + b))


def neg_reference(a):
    """The plain PyTorch modular negation (p - a, with -0 = 0).

    The JAX package reduces p - a by a conditional subtraction; p - a of
    a canonical a only reaches p at a = 0, so a select gives the same
    digits with one carry pass fewer."""
    diff, _ = _sub_exact(on_device(P_LIMBS, a.device), a)
    return torch.where(is_zero(a)[..., None], a, diff)


def sub_reference(a, b):
    """The plain PyTorch modular subtraction.

    The JAX package computes add(a, neg(b)), four carry passes; here
    a - b is exact digits mod 2^384 plus a borrow, and where it borrowed,
    adding p (the carry out of the top limb falls away) lands in [0, p).
    Two passes, the same canonical digits."""
    diff, borrow = _sub_exact(a, b)
    wrapped = resolve_carries(diff + on_device(P_LIMBS, diff.device))
    return torch.where(borrow[..., None] == 1, wrapped, diff)


def mont_mul(a, b):
    """Montgomery product (a b R^-1 mod p) of canonical-digit operands.

    Dispatches on the tensors' device: CPU tensors take the plain
    ``mont_mul_reference``; anything else goes to the CUDA kernel's
    wrapper, which launches it or raises.
    """
    if a.is_cpu and b.is_cpu:
        return mont_mul_reference(a, b)
    return K_MUL.mont_mul(a, b)


def mont_mul_reference(a, b):
    """The plain PyTorch Montgomery product: shift-based CIOS.

    T_{i+1} = (T_i + a_i b + m_i p) / beta with
    m_i = (T_i mod beta) * (-p^-1) mod beta.  The division is an exact
    one-limb shift because the low limb is forced to 0 mod beta.  After
    32 steps T < 2p; normalize + one conditional subtract canonicalizes.
    Line for line the JAX package's scan, with the scan as a loop.
    """
    a, b = torch.broadcast_tensors(a, b)
    p_limbs = on_device(P_LIMBS, b.device)
    t = torch.zeros_like(b)
    for i in range(N_LIMBS):
        t = t + a[..., i:i + 1] * b
        m = ((t[..., 0:1] & LIMB_MASK) * _P_INV_NEG) & LIMB_MASK
        t = t + m * p_limbs
        carry0 = t[..., 0:1] >> LIMB_BITS  # low limb is 0 mod beta by design
        t = torch.constant_pad_nd(t, (-1, 1))  # shift down one limb
        t[..., 0:1] += carry0
    return cond_sub_p(normalize(t))


def sqr(a):
    return mont_mul(a, a)


def to_mont(a):
    """Enter the Montgomery domain: a -> a R mod p."""
    return mont_mul(a, on_device(R2, a.device))


def from_mont(a):
    """Leave the Montgomery domain: a R -> a."""
    return mont_mul(a, on_device(_ONE_RAW, a.device))


def pow_fixed(a, exponent_bits):
    """a^e in the Montgomery domain, e given as a static MSB-first bit
    sequence; used for inversion.  The bits are host values, so a zero
    bit skips its multiply instead of computing and discarding it."""
    acc = on_device(ONE_MONT, a.device).expand(a.shape)
    for bit in exponent_bits:
        acc = mont_mul(acc, acc)
        if bit:
            acc = mont_mul(acc, a)
    return acc


def inv(a):
    """Modular inverse a^-1 = a^(p-2), with inv(0) = 0 (callers guard):
    one kernel launch for a CUDA tensor (a binary extended GCD), the plain
    ``inv_reference`` (Fermat's chain) for a CPU tensor."""
    if a.is_cpu:
        return inv_reference(a)
    return K_INV.inv(a)


def inv_reference(a):
    """The plain PyTorch inverse: a^(p-2) by ``pow_fixed``, 381 squarings
    and 229 products."""
    return pow_fixed(a, _P_MINUS_2_BITS)


def is_zero(a):
    """Boolean (...,) mask: element == 0 (canonical digits assumed)."""
    return (a == 0).all(dim=-1)


def select(mask, x, y):
    """Branchless per-element select; mask shape (...,), operands (..., 32)."""
    return torch.where(mask[..., None], x, y)
