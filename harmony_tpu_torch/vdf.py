"""Verifiable delay function: sequential sha3 hash chain.

Behavioral parity with the reference's in-repo PoC VDF (reference:
crypto/vdf/vdf.go:10-47): the proof that wall-clock time passed between
seeing the seed and producing the output is ``difficulty`` sequential
keccak-256 applications — inherently unparallelizable, so it stays on
the host CPU (SURVEY.md §2.1: CPU-bound sequential, not accelerator
work).  The
reference's production randomness uses an external Wesolowski VDF
library (go.mod:29, consumed at consensus/consensus_v2.go:955-1034);
the consensus-facing contract is the same: Evaluate(seed) -> output,
Verify(seed, output) by recomputation (the reference likewise verifies
its hash-chain PoC by re-running it).

The port's copy of the JAX package's ``vdf.py``.
"""

from __future__ import annotations

from .ref.keccak import keccak256


class VDF:
    """Hash-chain VDF with a fixed difficulty (iteration count)."""

    def __init__(self, difficulty: int):
        if difficulty < 1:
            raise ValueError("difficulty must be >= 1")
        self.difficulty = difficulty

    def evaluate(self, seed: bytes) -> bytes:
        """difficulty sequential keccak-256 rounds over the seed."""
        out = bytes(seed)
        for _ in range(self.difficulty):
            out = keccak256(out)
        return out

    def verify(self, seed: bytes, output: bytes) -> bool:
        """Recompute-and-compare (no succinct proof for a hash chain)."""
        return self.evaluate(seed) == output


def vrf_plus_vdf_randomness(vrf_output: bytes, vdf_output: bytes) -> bytes:
    """The chain's per-epoch randomness: keccak over the leader's VRF
    output mixed with the delayed VDF output (the reference feeds the
    VDF with the VRF-derived rnd preimage, consensus_v2.go:955-1034)."""
    return keccak256(vrf_output + vdf_output)
