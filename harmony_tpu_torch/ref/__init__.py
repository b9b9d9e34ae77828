"""Host-side bigint BLS12-381: parameters, tower fields, the affine group
law and hash-to-G2.  Pure Python; the port's own copy, so that it needs
nothing of the JAX package."""
