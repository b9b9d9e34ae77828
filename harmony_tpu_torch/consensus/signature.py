"""Signable payload construction for FBFT phases.

Behavioral parity with the reference (reference:
consensus/signature/signature.go:12-24): the commit-phase payload is

    LE64(blockNum) || blockHash(32) || LE64(viewID)   [staking epochs]
    LE64(blockNum) || blockHash(32)                   [pre-staking]

The prepare phase signs the bare 32-byte block hash (reference:
consensus/construct.go:99-105).
"""

import struct


def construct_commit_payload(
    block_hash: bytes, block_num: int, view_id: int, is_staking: bool = True
) -> bytes:
    if len(block_hash) != 32:
        raise ValueError("block hash must be 32 bytes")
    payload = struct.pack("<Q", block_num) + block_hash
    if is_staking:
        payload += struct.pack("<Q", view_id)
    return payload


def prepare_payload(block_hash: bytes) -> bytes:
    if len(block_hash) != 32:
        raise ValueError("block hash must be 32 bytes")
    return block_hash
