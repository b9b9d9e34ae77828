"""Double-sign slashing: evidence records, wire codec, and verification.

Behavioral parity with the reference (reference:
staking/slash/double-sign.go:32-75 record shape, :119-274 Verify;
consensus/double_sign.go:16-135 detection):

Evidence = two conflicting ballots (different block hashes, same height/
view) with overlapping signer keys; verification checks the conflict, the
signer overlap, committee membership, and BOTH ballot signatures against
the commit-phase payload (the only phase the reference slashes on —
double-sign.go builds evidence from commit ballots).

The wire/header codec (``encode_record``/``decode_records``) is what
rides block headers (``Header.slashes``, the v3 field the reference
carries slashing records in — block/v3/header.go:48-74) and the slash
gossip topic.  Decoding is BOUNDED: every count/length is checked
against the remaining bytes before any allocation, so a forged record
can cost at most its own wire size.

The port's copy of the JAX package's ``staking/slash.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .. import bls as B
from ..consensus.signature import construct_commit_payload, prepare_payload
from ..metrics import LockedCounters

# per-block inclusion cap (the reference bounds the slashes a block may
# carry; a flood of records must not stretch block execution unbounded)
MAX_SLASHES_PER_BLOCK = 8
# keys per ballot bound: a committee slot ballot never aggregates more
# keys than one operator holds; 512 covers mainnet multi-key operators
MAX_EVIDENCE_KEYS = 512

# pipeline observability (exposed as harmony_slash_* via
# metrics.Registry): detected -> gossiped/queued -> included ->
# verified -> applied, plus the atto amounts actually moved
COUNTERS = LockedCounters(
    "detected", "gossip_received", "queued", "included", "verified",
    "applied", "rejected", "dropped",
)
AMOUNTS = LockedCounters("slashed_atto", "reward_atto")


@dataclass
class Vote:
    """One of the conflicting votes (double-sign.go:45-50)."""

    signer_pubkeys: list  # serialized 48B keys
    block_header_hash: bytes
    signature: bytes  # 96B aggregate over the commit payload


@dataclass
class Moment:
    epoch: int
    shard_id: int
    height: int
    view_id: int


@dataclass
class Evidence:
    moment: Moment
    first_vote: Vote
    second_vote: Vote
    offender: bytes  # validator address


@dataclass
class Record:
    evidence: Evidence
    reporter: bytes


class SlashVerifyError(ValueError):
    pass


def detect_double_sign(
    existing_ballots: dict, new_key: bytes, new_hash: bytes
) -> bytes | None:
    """Leader-side detection (consensus/double_sign.go:16): a second vote
    by `new_key` for a different hash at the same (height, view).
    `existing_ballots` maps signer key -> block hash already voted."""
    prev = existing_ballots.get(new_key)
    if prev is not None and prev != new_hash:
        return prev
    return None


def verify_record(
    record: Record, committee_keys: list, is_staking: bool = True
) -> None:
    """Raises SlashVerifyError unless the evidence holds
    (double-sign.go:119-274, minus chain-state lookups which live with
    the caller).  A ballot check bound for the card that cannot run
    raises ``device.DeviceError``, not SlashVerifyError."""
    ev = record.evidence
    first, second = ev.first_vote, ev.second_vote

    if ev.offender == record.reporter:
        raise SlashVerifyError("reporter and offender are the same")
    for pk in first.signer_pubkeys + second.signer_pubkeys:
        if len(pk) != 48:
            raise SlashVerifyError("signer key not 48 bytes")
    if first.block_header_hash == second.block_header_hash:
        raise SlashVerifyError("votes do not conflict")

    overlap = [
        k1
        for k1 in first.signer_pubkeys
        if any(k1 == k2 for k2 in second.signer_pubkeys)
    ]
    if not overlap:
        raise SlashVerifyError("no matching double-sign keys")
    committee = set(committee_keys)
    for k in overlap:
        if k not in committee:
            raise SlashVerifyError("double-sign key not in committee")

    for vote in (first, second):
        payload = construct_commit_payload(
            vote.block_header_hash, ev.moment.height, ev.moment.view_id,
            is_staking,
        )
        if not B.verify_aggregate_bytes(
            vote.signer_pubkeys, payload, vote.signature
        ):
            # distinguish a WRONG-PHASE ballot (signed the prepare
            # payload — the bare block hash — instead of the commit
            # payload) from plain garbage: only commit ballots are
            # slashable evidence, and the caller's forensics want to
            # know which failure it was
            if B.verify_aggregate_bytes(
                vote.signer_pubkeys,
                prepare_payload(vote.block_header_hash),
                vote.signature,
            ):
                raise SlashVerifyError(
                    "ballot signed the wrong phase payload"
                )
            raise SlashVerifyError("ballot signature invalid")


@dataclass
class Application:
    """Slash application outcome (double-sign.go:62-66)."""

    total_slashed: int = 0
    total_beneficiary_reward: int = 0


def apply_slash(
    stake: int, rate_num: int = 2, rate_den: int = 100, reward_share_den: int = 2
) -> Application:
    """Economic application: slash rate of the offender's stake, half of
    the slashed amount rewards the reporter (the reference's
    applySlashRate/Apply shape, double-sign.go:445+)."""
    slashed = stake * rate_num // rate_den
    return Application(
        total_slashed=slashed,
        total_beneficiary_reward=slashed // reward_share_den,
    )


# -- wire / header codec ------------------------------------------------------
#
# Canonical little-endian layout (what Header.slashes and the slash
# gossip topic carry):
#
#   records := [u16 count] count * [u32 len][record]
#   record  := moment vote vote [u8 olen][offender][u8 rlen][reporter]
#   moment  := [u64 epoch][u32 shard][u64 height][u64 view]
#   vote    := [u16 n_keys] n_keys * 48B keys [32B hash][96B signature]
#
# Every count is checked against the remaining byte budget BEFORE any
# allocation happens: a length-inflated wire costs its own size, never
# a multiple of it.


def _encode_vote(v: Vote) -> bytes:
    if len(v.block_header_hash) != 32:
        raise ValueError("vote hash must be 32 bytes")
    if len(v.signature) != 96:
        raise ValueError("vote signature must be 96 bytes")
    out = bytearray(struct.pack("<H", len(v.signer_pubkeys)))
    for pk in v.signer_pubkeys:
        if len(pk) != 48:
            raise ValueError("signer key must be 48 bytes")
        out += pk
    out += v.block_header_hash + v.signature
    return bytes(out)


def _decode_vote(view: memoryview, off: int) -> tuple[Vote, int]:
    if len(view) - off < 2:
        raise ValueError("truncated vote")
    (n_keys,) = struct.unpack_from("<H", view, off)
    off += 2
    need = n_keys * 48 + 32 + 96
    if n_keys > MAX_EVIDENCE_KEYS or need > len(view) - off:
        raise ValueError(
            f"implausible vote key count {n_keys} for "
            f"{len(view) - off} bytes left"
        )
    keys = [bytes(view[off + 48 * i:off + 48 * (i + 1)])
            for i in range(n_keys)]
    off += 48 * n_keys
    block_hash = bytes(view[off:off + 32])
    off += 32
    sig = bytes(view[off:off + 96])
    off += 96
    return Vote(keys, block_hash, sig), off


def encode_record(r: Record) -> bytes:
    ev = r.evidence
    m = ev.moment
    if len(ev.offender) > 255 or len(r.reporter) > 255:
        raise ValueError("address too long")
    out = bytearray(struct.pack(
        "<QIQQ", m.epoch, m.shard_id, m.height, m.view_id
    ))
    out += _encode_vote(ev.first_vote)
    out += _encode_vote(ev.second_vote)
    out += bytes([len(ev.offender)]) + ev.offender
    out += bytes([len(r.reporter)]) + r.reporter
    return bytes(out)


def decode_record(blob: bytes) -> Record:
    view = memoryview(blob)
    if len(view) < 28:
        raise ValueError("truncated slash record")
    epoch, shard_id, height, view_id = struct.unpack_from("<QIQQ", view)
    off = 28
    first, off = _decode_vote(view, off)
    second, off = _decode_vote(view, off)
    if len(view) - off < 1:
        raise ValueError("truncated offender address")
    olen = view[off]; off += 1
    if len(view) - off < olen + 1:
        raise ValueError("truncated offender address")
    offender = bytes(view[off:off + olen]); off += olen
    rlen = view[off]; off += 1
    if len(view) - off < rlen:
        raise ValueError("truncated reporter address")
    reporter = bytes(view[off:off + rlen]); off += rlen
    if off != len(view):
        raise ValueError("trailing bytes in slash record")
    return Record(
        evidence=Evidence(
            moment=Moment(epoch, shard_id, height, view_id),
            first_vote=first, second_vote=second, offender=offender,
        ),
        reporter=reporter,
    )


def encode_records(records: list) -> bytes:
    if len(records) > MAX_SLASHES_PER_BLOCK:
        raise ValueError(
            f"{len(records)} slash records exceed the per-block cap "
            f"{MAX_SLASHES_PER_BLOCK}"
        )
    out = bytearray(struct.pack("<H", len(records)))
    for r in records:
        blob = encode_record(r)
        out += struct.pack("<I", len(blob)) + blob
    return bytes(out)


def decode_records(blob: bytes) -> list:
    view = memoryview(blob)
    if len(view) < 2:
        raise ValueError("truncated slash record list")
    (n,) = struct.unpack_from("<H", view)
    if n > MAX_SLASHES_PER_BLOCK:
        raise ValueError(f"{n} slash records exceed the per-block cap")
    off = 2
    out = []
    for _ in range(n):
        if len(view) - off < 4:
            raise ValueError("truncated slash record list")
        (ln,) = struct.unpack_from("<I", view, off)
        off += 4
        if ln > len(view) - off:
            raise ValueError(
                f"slash record length {ln} overruns the list"
            )
        out.append(decode_record(bytes(view[off:off + ln])))
        off += ln
    if off != len(view):
        raise ValueError("trailing bytes in slash record list")
    return out


def record_fingerprint(r: Record) -> bytes:
    """Content identity for gossip/queue dedup (one evidence pair =
    one record, regardless of who reports it): the reporter is OUTSIDE
    the fingerprint, exactly like the reference's CSV-key dedup
    (slash.go Records.SetDifference keys on the evidence)."""
    from ..ref.keccak import keccak256

    ev = r.evidence
    body = encode_record(Record(evidence=ev, reporter=b""))
    return keccak256(body)
