"""Quorum policies and the vote decider.

Behavioral parity with the reference's quorum package (reference:
consensus/quorum/quorum.go:111-196, one-node-one-vote.go,
one-node-staked-vote.go):

- uniform policy: quorum when > 2/3 of the committee key count has voted
  (strictly more than 2n/3, i.e. count * 3 > n * 2 is NOT enough — the
  reference requires >= 2n/3 + 1 keys; verifier.go:84-86);
- stake-weighted policy: quorum when tallied power > 2/3 exactly, in Dec
  fixed point over a votepower Roster;
- the decider stores one ballot per (phase, key) and can answer
  IsQuorumAchievedByMask for a bitmap without mutating state.

The decider is host-side bookkeeping; signature verification of the
ballots rides the device batch ops.  The port's copy of the JAX package's
``consensus/quorum.py``.
"""

from __future__ import annotations

from enum import Enum

from ..numeric import Dec, new_dec, zero_dec
from .votepower import Roster

_TWO_THIRDS_NUM, _TWO_THIRDS_DEN = 2, 3


class Phase(Enum):
    PREPARE = "prepare"
    COMMIT = "commit"
    VIEWCHANGE = "viewchange"


class Policy(Enum):
    UNIFORM = "one-node-one-vote"
    STAKED = "stake-weighted"


class Ballot:
    __slots__ = ("signer_key", "block_hash", "signature", "height", "view_id")

    def __init__(self, signer_key, block_hash, signature, height, view_id):
        self.signer_key = signer_key
        self.block_hash = block_hash
        self.signature = signature
        self.height = height
        self.view_id = view_id


def uniform_quorum_threshold(committee_size: int) -> int:
    """Minimum key count for uniform quorum: 2n/3 + 1 (integer floor)."""
    return committee_size * _TWO_THIRDS_NUM // _TWO_THIRDS_DEN + 1


def staked_quorum_threshold() -> Dec:
    """Stake-weighted quorum bar: strictly more than 2/3 of total power."""
    return new_dec(_TWO_THIRDS_NUM).quo(new_dec(_TWO_THIRDS_DEN))


class Decider:
    """Ballot store + quorum evaluation for one committee/epoch."""

    def __init__(self, policy: Policy, committee_keys, roster: Roster | None = None):
        self.policy = policy
        self.keys = list(committee_keys)
        self.key_index = {k: i for i, k in enumerate(self.keys)}
        self.roster = roster
        if policy is Policy.STAKED and roster is None:
            raise ValueError("stake-weighted policy requires a roster")
        self._ballots = {p: {} for p in Phase}

    # --- voting ---
    def submit_vote(self, phase: Phase, ballot: Ballot) -> bool:
        """Store a ballot; reject duplicates per (phase, key) the way the
        reference's cIdentities ballot box does (quorum.go:152-163)."""
        box = self._ballots[phase]
        if ballot.signer_key in box:
            return False
        if ballot.signer_key not in self.key_index:
            raise KeyError("signer not in committee")
        box[ballot.signer_key] = ballot
        return True

    def count(self, phase: Phase) -> int:
        return len(self._ballots[phase])

    def has_voted(self, phase: Phase, key) -> bool:
        return key in self._ballots[phase]

    def ballots(self, phase: Phase):
        return list(self._ballots[phase].values())

    def signers_bitmap(self, phase: Phase):
        import numpy as np

        bits = np.zeros(len(self.keys), dtype=np.int32)
        for k in self._ballots[phase]:
            bits[self.key_index[k]] = 1
        return bits

    def reset(self, phases=None):
        for p in phases or list(Phase):
            self._ballots[p] = {}

    # --- power tally ---
    def _power_of_keys(self, keys) -> Dec:
        total = zero_dec()
        for k in keys:
            voter = self.roster.voters.get(k)
            if voter is not None:
                total = total.add(voter.overall_percent)
        return total

    def tallied_power(self, phase: Phase) -> Dec:
        return self._power_of_keys(self._ballots[phase].keys())

    # --- quorum ---
    def is_quorum_achieved(self, phase: Phase) -> bool:
        if self.policy is Policy.UNIFORM:
            return self.count(phase) >= uniform_quorum_threshold(len(self.keys))
        return self.tallied_power(phase).gt(staked_quorum_threshold())

    def is_quorum_achieved_by_mask(self, bitmap) -> bool:
        """Stateless quorum check for a participation bitmap (the
        PREPARED/COMMITTED validation path — reference:
        consensus/quorum/verifier.go:46-86).

        Deliberate strengthening vs the reference: its uniform mask check
        compares the FULL committee size against the threshold
        (verifier.go:76 `len(mask.Publics)`), which is vacuously true for
        any committee larger than 3 — real enforcement happens in the
        ballot decider.  Here the ENABLED-bit count is held to the same
        >= 2n/3 + 1 bar as the ballot path, so leader and validators
        agree at exact quorum.
        """
        enabled = [self.keys[i] for i, b in enumerate(bitmap) if b]
        if self.policy is Policy.UNIFORM:
            return len(enabled) >= uniform_quorum_threshold(len(self.keys))
        return self._power_of_keys(enabled).gt(staked_quorum_threshold())
