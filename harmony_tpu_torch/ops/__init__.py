"""Batched BLS12-381 compute path in PyTorch, on CUDA or the CPU.

Layout conventions (little-endian limbs, Montgomery domain, R = 2^384),
the same as the JAX package's:

    Fp   : int32[..., 32]          32 limbs x 12 bits  (base 2^12)
    Fp2  : int32[..., 2, 32]       c0 + c1 u
    Fp6  : int32[..., 3, 2, 32]    c0 + c1 v + c2 v^2
    Fp12 : int32[..., 2, 3, 2, 32] d0 + d1 w
    G1   : int32[..., 3, 32]       Jacobian (X, Y, Z) over Fp
    G2   : int32[..., 3, 2, 32]    Jacobian (X, Y, Z) over Fp2

All ops are batched over leading axes and run on the device their input
tensors lie on.  Every Fp product goes through ops/fp.py ``mont_mul``,
and the Fp12 product, square and cyclotomic squarings through
ops/towers.py: a hand-written CUDA kernel for a CUDA tensor, its plain
PyTorch version for a CPU tensor.
"""
