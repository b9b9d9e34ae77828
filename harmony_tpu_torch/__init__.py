"""harmony_tpu_torch: the BLS12-381 quorum-verify path of harmony_tpu,
ported to PyTorch, with its Fp multiply as a hand-written CUDA kernel for
NVIDIA Hopper.

It mirrors harmony_tpu's module paths and public names (``ops/fp.py``,
``ops/towers.py``, ``ops/curve.py``, ``ops/pairing.py``, ``ops/bls.py``,
``device.py``) and its tensor layout, so that each module can be held
against its JAX counterpart bit for bit.  It imports torch and numpy and
nothing of JAX or of harmony_tpu.
"""
