"""Bigint-backed twins of the BLS kernels' entry points (ops/bls.py).

Same signatures, same padded tensor layouts, REAL verify decisions —
but the innermost pairing runs on the host crypto path (native C++
when loaded, bigint otherwise) instead of the kernels.
``HARMONY_KERNEL_TWIN=1`` swaps these in behind device.py's kernel
switch, so tests can exercise every layer above the kernels — the
scheduler, CommitteeTable padding, bitmap routing, counters, batch
chunking — on a CPU where one pairing product on the plain path takes
seconds.  The kernels and their plain versions are held against the
JAX package by the port's other tests.

Wrong padding, table layout, or result slicing fails loudly — the
twins convert the exact tensors the kernels would receive.  They return
numpy arrays; device.py reads them as it reads a kernel's tensors.
They take no tensor on the card: the card's checks run on its kernels.
"""

from __future__ import annotations

import numpy as np

from ..ref import bls as RB
from . import interop as I

CALLS = {"verify": 0, "agg_verify": 0, "agg_verify_batch": 0}


def _host(x):
    if getattr(x, "is_cuda", False):
        raise RuntimeError("the bigint twins take no tensor on the card")
    return I._host(x)


def _aff_g1(arr):
    return (I.arr_to_fp(arr[0]), I.arr_to_fp(arr[1]))


def _aff_g2(arr):
    return (I.arr_to_fp2(arr[0]), I.arr_to_fp2(arr[1]))


def _masked_agg(tbl: np.ndarray, bits: np.ndarray):
    pts = [_aff_g1(tbl[i]) for i, bit in enumerate(bits) if bit]
    return RB.aggregate_pubkeys(pts) if pts else None


def agg_verify(tbl, bits, h_arr, sig_arr):
    """Twin of ops/bls.agg_verify: one masked quorum check."""
    CALLS["agg_verify"] += 1
    agg = _masked_agg(_host(tbl), _host(bits))
    if agg is None:
        return np.asarray(False)
    ok = RB.verify_hashed(
        agg, _aff_g2(_host(h_arr)), _aff_g2(_host(sig_arr))
    )
    return np.asarray(bool(ok))


def agg_verify_batch(tbl, bitmaps, h_arrs, sig_arrs):
    """Twin of ops/bls.agg_verify_batch: B masked checks, one table."""
    CALLS["agg_verify_batch"] += 1
    tbl = _host(tbl)
    out = []
    for bits, h, s in zip(_host(bitmaps), _host(h_arrs),
                          _host(sig_arrs)):
        agg = _masked_agg(tbl, bits)
        if agg is None:
            out.append(False)
            continue
        out.append(bool(RB.verify_hashed(agg, _aff_g2(h), _aff_g2(s))))
    return np.asarray(out)


def verify(pk_arrs, h_arrs, sig_arrs):
    """Twin of ops/bls.verify: lane-wise single checks."""
    CALLS["verify"] += 1
    out = []
    for pk, h, s in zip(_host(pk_arrs), _host(h_arrs),
                        _host(sig_arrs)):
        pk_pt = _aff_g1(pk)
        if pk_pt == (0, 0):
            out.append(False)
            continue
        out.append(bool(RB.verify_hashed(pk_pt, _aff_g2(h), _aff_g2(s))))
    return np.asarray(out)
