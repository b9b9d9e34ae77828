"""Per-committee voting-power roster.

Behavioral parity with the reference's votepower.Compute (reference:
consensus/votepower/roster.go:158-240): Harmony-operated slots split the
configured Harmony share equally; external stakers split the remainder
pro-rata by effective stake; the rounding residue is assigned to the last
staked voter so the total is forced to exactly 1.0.

All math is host-side ``Dec`` fixed point — quorum decisions must be
bitwise identical across nodes (SURVEY.md §2.4).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..numeric import Dec, new_dec, one_dec, zero_dec


@dataclass
class Slot:
    """One committee slot (reference: shard/shard_state.go:40-49)."""

    address: str
    bls_pubkey: bytes
    effective_stake: Dec | None = None  # None marks a Harmony-operated slot


@dataclass
class Voter:
    address: str
    bls_pubkey: bytes
    is_harmony: bool
    group_percent: Dec = field(default_factory=zero_dec)
    overall_percent: Dec = field(default_factory=zero_dec)
    effective_stake: Dec = field(default_factory=zero_dec)


@dataclass
class Roster:
    voters: dict  # bls_pubkey -> Voter
    ordered_keys: list
    our_voting_power: Dec
    their_voting_power: Dec
    total_effective_stake: Dec
    harmony_slot_count: int


def compute_roster(
    slots: list[Slot], harmony_percent: Dec, external_percent: Dec
) -> Roster:
    total_stake = zero_dec()
    hmy_count = 0
    for s in slots:
        if s.effective_stake is not None:
            total_stake = total_stake.add(s.effective_stake)
        else:
            hmy_count += 1

    ours, theirs = zero_dec(), zero_dec()
    voters: dict = {}
    ordered = []
    last_staked: Voter | None = None
    last_any: Voter | None = None
    hmy_count_dec = new_dec(hmy_count) if hmy_count else None

    for s in slots:
        if s.effective_stake is not None:
            group = s.effective_stake.quo(total_stake)
            overall = group.mul(external_percent)
            v = Voter(
                address=s.address,
                bls_pubkey=s.bls_pubkey,
                is_harmony=False,
                group_percent=group,
                overall_percent=overall,
                effective_stake=s.effective_stake,
            )
            theirs = theirs.add(overall)
            last_staked = v
        else:
            overall = harmony_percent.quo(hmy_count_dec)
            v = Voter(
                address=s.address,
                bls_pubkey=s.bls_pubkey,
                is_harmony=True,
                group_percent=overall.quo(harmony_percent),
                overall_percent=overall,
            )
            ours = ours.add(overall)
        if s.bls_pubkey not in voters:
            voters[s.bls_pubkey] = v
        ordered.append(s.bls_pubkey)
        last_any = v

    # force the sum to exactly one: residue goes to the last staked voter
    # (matching the reference), or to the last voter of any kind for an
    # all-Harmony committee — the invariant must hold unconditionally
    residue_taker = last_staked if last_staked is not None else last_any
    diff = one_dec().sub(ours.add(theirs))
    if not diff.is_zero() and residue_taker is not None:
        residue_taker.overall_percent = residue_taker.overall_percent.add(diff)
        if residue_taker.is_harmony:
            ours = ours.add(diff)
        else:
            theirs = theirs.add(diff)
    if slots and not ours.add(theirs).equal(one_dec()):
        raise ValueError("voting power does not sum to one")

    return Roster(
        voters=voters,
        ordered_keys=ordered,
        our_voting_power=ours,
        their_voting_power=theirs,
        total_effective_stake=total_stake,
        harmony_slot_count=hmy_count,
    )
