"""The device entry points of the quorum-verify path.

A committee's pubkeys live on the device as one padded table
(``CommitteeTable``); each check ships a bitmap, a hashed payload and a
signature, and gets a bool back.  Every entry point runs on CUDA unless
the caller asks for the CPU (``device="cpu"``, as the tests do); with no
CUDA and no explicit device it raises.  A failed dispatch raises too:
there is no host fallback in this package yet.

``COUNTERS`` records how many checks ran, so a run can assert that the
path was live.
"""

import threading

import numpy as np
import torch

from .ops import bls as OB
from .ops import interop as I

COUNTERS = {"verify": 0, "agg_verify": 0, "batch_verify": 0}


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# Committee tables are padded to one of these pinned sizes (pad keys are
# affine (0,0) = infinity, masked off by zero bitmap bits).
COMMITTEE_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


def committee_bucket(n: int) -> int:
    """Smallest pinned bucket admitting ``n`` committee slots.  Widths
    past the largest bucket raise: no deployed committee exceeds 1024
    slots, and admitting one is a registry change."""
    for b in COMMITTEE_BUCKETS:
        if n <= b:
            return b
    raise ValueError(
        f"committee width {n} exceeds the largest pinned bucket "
        f"{COMMITTEE_BUCKETS[-1]}; extend COMMITTEE_BUCKETS to admit it")


class CommitteeTable:
    """A committee's pubkeys as ONE device-resident padded affine tensor
    (size, 2, 32), so that steady-state quorum checks ship only a bitmap
    and a signature to the device."""

    def __init__(self, points, device=None):
        arr = np.zeros((committee_bucket(max(len(points), 1)), 2, 32),
                       dtype=np.int32)
        if points:
            arr[: len(points)] = I.g1_batch_affine(points).numpy()
        self._init(arr, len(points), device)

    @classmethod
    def from_numpy(cls, arr, n: int, device=None) -> "CommitteeTable":
        """A table from the JAX package's ``CommitteeTable._np``: an
        (size, 2, 32) int32 array whose first ``n`` rows are the keys and
        whose pad rows are affine (0, 0)."""
        arr = np.asarray(arr, dtype=np.int32)
        if arr.ndim != 3 or arr.shape[1:] != (2, 32):
            raise ValueError(f"table must be (size, 2, 32), got {arr.shape}")
        if arr.shape[0] != committee_bucket(max(n, 1)):
            raise ValueError(
                f"table of {arr.shape[0]} rows is not the bucket of {n} keys")
        table = cls.__new__(cls)
        table._init(arr, n, device)
        return table

    def _init(self, arr, n, device):
        self.n = n
        self.size = arr.shape[0]
        self.device = resolve_device(device)
        self._dev = torch.from_numpy(arr).to(self.device)

    def device_array(self) -> torch.Tensor:
        return self._dev

    def pad_bits(self, bits) -> np.ndarray:
        out = np.zeros((self.size,), dtype=np.int32)
        out[: self.n] = np.asarray(bits, dtype=np.int32)[: self.n]
        return out


_TABLE_CACHE: "dict[tuple, CommitteeTable]" = {}
_TABLE_CACHE_CAP = 8
_TABLE_CACHE_LOCK = threading.Lock()


def get_committee_table(serialized_keys, points, device=None) -> CommitteeTable:
    """Per-committee table cache, keyed by the serialized key tuple and
    the device; bounded at 8 tables (a node tracks at most its own and a
    few foreign committees at once).  The table build runs outside the
    lock: a duplicate build loses only work."""
    device = resolve_device(device)
    key = (tuple(serialized_keys), str(device))
    with _TABLE_CACHE_LOCK:
        tbl = _TABLE_CACHE.get(key)
    if tbl is None:
        tbl = CommitteeTable(points, device)
        with _TABLE_CACHE_LOCK:
            if (key not in _TABLE_CACHE
                    and len(_TABLE_CACHE) >= _TABLE_CACHE_CAP):
                _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
            tbl = _TABLE_CACHE.setdefault(key, tbl)
    return tbl


# Pinned batch widths for the replay path: the CPU caps at 64 lanes.
BATCH_BUCKETS_CPU = (8, 64)
BATCH_BUCKETS_GPU = (8, 64, 256)

_VERIFY_BUCKET = 8


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def batch_buckets(device) -> tuple:
    return BATCH_BUCKETS_GPU if _on_card(device) else BATCH_BUCKETS_CPU


def batch_bucket(n: int, device) -> int:
    """Smallest pinned batch width admitting ``n`` lanes, clamped to the
    widest (callers chunk)."""
    for b in batch_buckets(device):
        if n <= b:
            return b
    return batch_buckets(device)[-1]


def agg_verify_hashed_on_device(table: CommitteeTable, bits, h_point,
                                sig_point) -> bool:
    """THE FBFT quorum check, payload already hashed to G2: committee
    table resident on the table's device, bitmap in, bool out — masked
    G1 tree-sum and the 2-pairing product in one pass."""
    COUNTERS["agg_verify"] += 1
    dev = table.device
    bm = torch.from_numpy(table.pad_bits(bits)).to(dev)
    hh = I.g2_affine_to_arr(h_point).to(dev)
    sg = I.g2_affine_to_arr(sig_point).to(dev)
    ok = OB.agg_verify(table.device_array(), bm, hh, sg)
    return bool(ok.cpu())


def agg_verify_batch_on_device(table: CommitteeTable, bits_list,
                               h_points, sig_points) -> list:
    """Replay-path batch: B quorum checks against one committee table,
    chunked to pinned batch widths (pad lanes repeat lane 0 and are
    sliced off).  h_points are pre-hashed payload points; returns
    list[bool]."""
    dev = table.device
    widest = batch_buckets(dev)[-1]
    tbl = table.device_array()
    # dispatch EVERY chunk before syncing ANY result: a per-chunk copy to
    # the host inside this loop would wait on the device between chunks
    pending = []  # (ok device tensor, live lane count)
    for start in range(0, len(bits_list), widest):
        chunk_bits = bits_list[start:start + widest]
        chunk_h = h_points[start:start + widest]
        chunk_s = sig_points[start:start + widest]
        n, padded = len(chunk_bits), batch_bucket(len(chunk_bits), dev)
        sel = list(range(n)) + [0] * (padded - n)
        bm = np.stack([table.pad_bits(chunk_bits[i]) for i in sel])
        hh = I.g2_batch_affine([chunk_h[i] for i in sel])
        sg = I.g2_batch_affine([chunk_s[i] for i in sel])
        ok = OB.agg_verify_batch(tbl, torch.from_numpy(bm).to(dev),
                                 hh.to(dev), sg.to(dev))
        COUNTERS["batch_verify"] += 1
        pending.append((ok, n))
    results = []
    for ok, n in pending:
        results.extend(bool(x) for x in ok.cpu()[:n])
    return results


def verify_on_device(pk_point, payload: bytes, sig_point,
                     device=None) -> bool:
    """One check e(-G1, sig) e(pk, H(payload)) == 1.  On the card it pads
    to the pinned width 8 so every single check shares one shape; on
    the CPU it runs width 1.

    pk_point: reference affine G1 point; sig_point: affine G2 point;
    payload: signed bytes (hash-to-G2 runs on the host)."""
    from .ref.hash_to_curve import hash_to_g2

    dev = resolve_device(device)
    h = hash_to_g2(payload)
    COUNTERS["verify"] += 1
    width = _VERIFY_BUCKET if _on_card(dev) else 1
    pk = I.g1_batch_affine([pk_point] * width).to(dev)
    hh = I.g2_batch_affine([h] * width).to(dev)
    sg = I.g2_batch_affine([sig_point] * width).to(dev)
    return bool(OB.verify(pk, hh, sg)[0].cpu())


def verify_many_on_device(pk_points, h_points, sig_points,
                          device=None) -> list:
    """N *independent* single checks — distinct keys, distinct payload
    points — in pinned-width batches (on the card; the CPU runs each
    chunk at its own width).  h_points are pre-hashed payload G2 points.
    Pad lanes are affine infinity, sliced off before return."""
    dev = resolve_device(device)
    n_total = len(pk_points)
    COUNTERS["verify"] += n_total
    widest = batch_buckets(dev)[-1]
    pending = []  # (ok device tensor, live lane count)
    for start in range(0, n_total, widest):
        chunk_pk = pk_points[start:start + widest]
        chunk_h = h_points[start:start + widest]
        chunk_s = sig_points[start:start + widest]
        n = len(chunk_pk)
        pad = (batch_bucket(n, dev) if _on_card(dev) else n) - n
        pk = _pad_lanes(I.g1_batch_affine(chunk_pk), pad)
        hh = _pad_lanes(I.g2_batch_affine(chunk_h), pad)
        sg = _pad_lanes(I.g2_batch_affine(chunk_s), pad)
        pending.append((OB.verify(pk.to(dev), hh.to(dev), sg.to(dev)), n))
    results = []
    for ok, n in pending:
        results.extend(bool(x) for x in ok.cpu()[:n])
    return results


def _pad_lanes(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` lanes of affine infinity (all-zero limbs)."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
