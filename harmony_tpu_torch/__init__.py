"""harmony_tpu_torch: the BLS12-381 verification path of harmony_tpu,
ported to PyTorch, with its arithmetic in hand-written CUDA kernels for
NVIDIA Hopper.

It mirrors harmony_tpu's module paths and public names (``ops/``,
``device.py``, the host path ``ref/``, the node's verification layer
``bls.py``, ``consensus/mask.py`` and ``sched/``, its consumers, the node
itself under ``node/`` with the chain ``core/``, ``p2p/`` and
``config/``, and the support modules they need) and its tensor layout,
so that each module can be held against its JAX counterpart.  It imports torch and numpy and nothing of
JAX or of harmony_tpu.
"""
