"""Hand-written Hopper kernels and their wrappers.

Each module builds its kernel from ``harmony_tpu_torch/csrc/`` at first
use (never at import), counts its launches in ``LAUNCHES``, and names
the TPU kernel it replaces.
"""
