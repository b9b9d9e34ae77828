"""The consensus engine's signature-verification surface.

Behavioral parity with the reference's engine (reference:
internal/chain/engine.go:576-683 + internal/chain/sig.go:13-50):

- ``decode_sig_bitmap``: split + deserialize an aggregate commit proof
  against an epoch committee (DecodeSigBitmap);
- ``verify_header_signature``: epoch-context cache -> quorum-by-mask ->
  ONE aggregate pairing check, with a verified-signature LRU keyed on
  (hash, sig, bitmap) so replayed checks are free (engine.go:606-617;
  the reference caps the cache key at 64-byte bitmaps = 512 validators,
  engine.go:660-662 — this implementation has no such cap);
- ``verify_headers_batch``: the block-replay throughput path (reference
  call stack SURVEY.md §3.3): each header's commit payload is rebuilt,
  all masked committee aggregations and ALL pairing checks for the batch
  run as one device program — the reference does these one block at a
  time through cgo.

The port's copy of the JAX package's ``chain/engine.py``.  The device path
is the port's: committee tables on the node's device
(``device.resolve_device()``), checks through the verification scheduler
(``sched``) into ``device.py``'s breaker-guarded entry points.  A check
bound for CUDA that the card cannot run raises ``device.DeviceError``;
it is never answered False.  The host path (``device=False``, or the
device path switched off) is the reference's host mode, not a fallback.
"""

from __future__ import annotations

from collections import OrderedDict

from .. import prof
from ..consensus.mask import Mask, bits_from_bytes
from ..consensus.quorum import Decider, Policy
from ..consensus.signature import construct_commit_payload
from ..ref import bls as RB
from .header import Header


class EpochContext:
    """Per-(shard, epoch) committee context: deserialized keys, quorum
    decider, device table (reference: engine.go:644-663 getEpochCtxCached)."""

    def __init__(self, committee_keys: list, policy: Policy = Policy.UNIFORM,
                 roster=None):
        self.serialized = list(committee_keys)
        self.points = [RB.pubkey_from_bytes(k) for k in committee_keys]
        self.decider = Decider(policy, committee_keys, roster)
        self._device_aff = None
        self._table = None

    def device_table(self):
        """(N, 2, 32) affine Montgomery tensor of the committee's keys on
        the node's device."""
        from .. import device as DV
        from ..ops import interop as I

        if self._device_aff is None:
            self._device_aff = I.g1_batch_affine(self.points).to(
                DV.resolve_device())
        return self._device_aff

    def committee_table(self):
        """Padded device-resident table for the fused agg_verify path."""
        from .. import device as DV

        if self._table is None:
            self._table = DV.CommitteeTable(self.points)
        return self._table

    def __len__(self):
        return len(self.serialized)


class _LRU(OrderedDict):
    def __init__(self, cap: int):
        super().__init__()
        self.cap = cap

    def put(self, key):
        self[key] = True
        self.move_to_end(key)
        while len(self) > self.cap:
            self.popitem(last=False)


# Device batches are padded up to one of these pinned sizes (chunked
# above the largest) so every verify reuses one program shape (SURVEY.md
# §7.3: "pinned batch shapes with bucketing").  The CPU caps at 64; the
# card takes the wide bucket for replay throughput.  The counterparts of
# device.BATCH_BUCKETS_CPU / BATCH_BUCKETS_GPU.
VERIFY_BUCKETS_CPU = (8, 64)
VERIFY_BUCKETS_GPU = (8, 64, 256)


def verify_buckets() -> tuple:
    """The buckets of the node's device (else CUDA), as
    ``device.batch_buckets`` chooses them: whether the device is CUDA
    decides, not whether the device path is on (it can be on with the
    node's device set to the CPU).  With no node device and no CUDA, the
    CPU's."""
    from .. import device as DV

    try:
        on_card = DV.resolve_device().type == "cuda"
    except RuntimeError:  # no node device, and CUDA is not available
        on_card = False
    return VERIFY_BUCKETS_GPU if on_card else VERIFY_BUCKETS_CPU


# back-compat name (tests reference it)
VERIFY_BUCKETS = VERIFY_BUCKETS_CPU


def bucket_size(n: int) -> int:
    buckets = verify_buckets()
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Engine:
    """Header signature verification with epoch-ctx + verified-sig caches."""

    def __init__(self, committee_provider, sig_cache_size: int = 4096,
                 device: bool | None = None, backend=None):
        """committee_provider(shard_id, epoch) -> EpochContext.

        ``device=None`` (default) resolves automatically:
        ``device.device_enabled()``, which is True by AUTO where CUDA is
        available and as ``device.use_device`` forces it otherwise.  The
        device path runs on the node's device; ``device=False`` is the
        host path.

        ``backend``: an out-of-process verification service with the
        SidecarClient surface (set_committee / agg_verify) — SURVEY
        §7.3's accelerator sidecar.  When set, quorum checks ship the
        (bitmap, payload, sig) triple over the wire and the sidecar
        owns the committee tables + device dispatch; the in-process
        paths above are bypassed."""
        if device is None:
            from .. import device as DV

            device = DV.device_enabled()
        self._provider = committee_provider
        self._epoch_ctx: dict = {}
        self._verified = _LRU(sig_cache_size)
        self.device = device
        self.backend = backend
        self._backend_committees: set = set()  # (shard, epoch) pushed

    def _ensure_backend_committee(self, ctx: EpochContext,
                                  header: Header) -> None:
        """Push (shard, epoch)'s committee to the sidecar exactly once
        per engine lifetime (the client replays it on reconnect)."""
        key = (header.shard_id, header.epoch)
        if key not in self._backend_committees:
            self.backend.set_committee(
                header.epoch, header.shard_id, list(ctx.serialized)
            )
            self._backend_committees.add(key)

    def _backend_verify(self, ctx: EpochContext, header: Header,
                        payload: bytes, sig_bytes: bytes,
                        bitmap: bytes) -> bool:
        self._ensure_backend_committee(ctx, header)
        return self.backend.agg_verify(
            header.epoch, header.shard_id, payload, bitmap, sig_bytes
        )

    def epoch_context(self, shard_id: int, epoch: int) -> EpochContext:
        key = (shard_id, epoch)
        ctx = self._epoch_ctx.get(key)
        if ctx is None:
            ctx = self._provider(shard_id, epoch)
            self._epoch_ctx[key] = ctx
        return ctx

    def decode_sig_bitmap(self, ctx: EpochContext, sig_bytes: bytes,
                          bitmap: bytes):
        """(signature point, Mask) or ValueError (sig.go:37-50)."""
        sig = RB.sig_from_bytes(sig_bytes)
        if sig is None:
            raise ValueError("aggregate signature is infinity")
        mask = Mask(ctx.points)
        mask.set_mask(bitmap)
        return sig, mask

    def _commit_payload(self, header: Header, is_staking: bool) -> bytes:
        return construct_commit_payload(
            header.hash(), header.block_num, header.view_id, is_staking
        )

    def verify_header_signature(
        self, header: Header, sig_bytes: bytes, bitmap: bytes,
        is_staking: bool = True, lane=None,
    ) -> bool:
        """One header's aggregate commit check (engine.go:576-642).
        ``lane`` picks the verification scheduler's priority lane
        (default: the sync lane — replay is the engine's home turf;
        the node's live-commit path passes CONSENSUS)."""
        cache_key = (header.hash(), sig_bytes, bitmap)
        if cache_key in self._verified:
            return True
        ctx = self.epoch_context(header.shard_id, header.epoch)
        try:
            sig, mask = self.decode_sig_bitmap(ctx, sig_bytes, bitmap)
        except ValueError:
            return False
        if not ctx.decider.is_quorum_achieved_by_mask(mask.bit_vector()):
            return False
        payload = self._commit_payload(header, is_staking)
        if self.backend is not None:
            ok = self._backend_verify(ctx, header, payload, sig_bytes, bitmap)
            if not ok:
                return False
            self._verified.put(cache_key)
            return True
        if self.device:
            # fused path: committee table stays device-resident; the
            # masked G1 tree-sum AND the pairing check run as ONE
            # program, submitted through the shared verification
            # scheduler so concurrent callers coalesce into the
            # pinned buckets instead of interleaving lone dispatches
            from .. import sched

            ok = sched.agg_verify(
                ctx.committee_table(), mask.bit_vector(), payload, sig,
                lane=sched.Lane.SYNC if lane is None else lane,
            )
        else:
            agg_pk = mask.aggregate_public(device=False)
            if agg_pk is None:
                return False
            ok = RB.verify(agg_pk, payload, sig)
        if not ok:
            return False
        self._verified.put(cache_key)
        return True

    def verify_seal(self, header: Header, child: Header,
                    is_staking: bool = True, lane=None) -> bool:
        """Verify header via the commit proof its CHILD carries
        (engine.go:237-262 VerifySeal)."""
        return self.verify_header_signature(
            header, child.last_commit_sig, child.last_commit_bitmap,
            is_staking, lane=lane,
        )

    # --- the batched replay path ------------------------------------------

    def verify_headers_batch(
        self, items: list, is_staking=True, lane=None
    ) -> list:
        """items: [(header, sig_bytes, bitmap)].  All masked committee
        aggregations and pairing checks run as ONE device program — the
        throughput path for chain replay (BASELINE config #5) — routed
        through the verification scheduler's sync lane (or ``lane``).

        Committees may differ per header (cross-epoch batches are fine);
        quorum checks and payload construction stay host-side exactly as
        the deterministic reference logic demands.  ``is_staking`` is a
        bool for the whole batch or a per-item list (a batch spanning
        the staking-epoch boundary changes the commit payload shape).
        """
        from ..ref.hash_to_curve import hash_to_g2

        flags = (
            list(is_staking)
            if isinstance(is_staking, (list, tuple))
            else [is_staking] * len(items)
        )
        if len(flags) != len(items):
            raise ValueError("is_staking list length != items length")
        if self.backend is not None:
            from .. import sched

            if not sched.enabled():
                # pre-scheduler behavior: the per-header path (which
                # also carries the verified-sig cache and retries)
                return [
                    self.verify_header_signature(h, s, b, flags[i],
                                                 lane=lane)
                    for i, (h, s, b) in enumerate(items)
                ]
        results = [False] * len(items)
        # survivors grouped by committee context: each group runs as one
        # fused device batch (bitmaps + hashed payloads + sigs in, bools
        # out — the masked aggregations happen ON DEVICE, not as N
        # host G1 adds per header).  The sidecar-backend path
        # shares this loop: its survivors pipeline over the wire via
        # the scheduler instead of serializing one round-trip per
        # header (the old per-header fallback made a cross-epoch batch
        # cost N round-trips).
        groups: dict = {}  # id(ctx) -> (ctx, [(idx, bits, h_pt, sig)])
        host_survivors = []  # (idx, agg_pk, h_pt, sig) — host path only
        backend_calls = []  # (idx, header, ctx, payload) — sidecar path
        for idx, (header, sig_bytes, bitmap) in enumerate(items):
            cache_key = (header.hash(), sig_bytes, bitmap)
            if cache_key in self._verified:
                results[idx] = True
                continue
            ctx = self.epoch_context(header.shard_id, header.epoch)
            try:
                sig, mask = self.decode_sig_bitmap(ctx, sig_bytes, bitmap)
            except ValueError:
                continue
            if not ctx.decider.is_quorum_achieved_by_mask(mask.bit_vector()):
                continue
            payload = self._commit_payload(header, flags[idx])
            if self.backend is not None:
                backend_calls.append((idx, header, ctx, payload))
                continue
            with prof.stage("hash_to_g2"):
                h_pt = hash_to_g2(payload)
            if self.device:
                groups.setdefault(id(ctx), (ctx, []))[1].append(
                    (idx, mask.bit_vector(), h_pt, sig)
                )
            else:
                agg_pk = mask.aggregate_public(device=False)
                if agg_pk is None:
                    continue
                host_survivors.append((idx, agg_pk, h_pt, sig))
        if self.backend is not None:
            return self._backend_verify_batch(
                items, flags, results, backend_calls, lane
            )
        if not self.device:
            for idx, agg_pk, h_pt, sig in host_survivors:
                if RB.verify_hashed(agg_pk, h_pt, sig):
                    results[idx] = True
                    header, sig_bytes, bitmap = items[idx]
                    self._verified.put((header.hash(), sig_bytes, bitmap))
            return results
        from .. import sched

        for ctx, entries in groups.values():
            ok = sched.agg_verify_many(
                ctx.committee_table(),
                [e[1] for e in entries],
                [e[2] for e in entries],
                [e[3] for e in entries],
                lane=sched.Lane.SYNC if lane is None else lane,
            )
            for (idx, _, _, _), good in zip(entries, ok):
                if good:
                    results[idx] = True
                    header, sig_bytes, bitmap = items[idx]
                    self._verified.put((header.hash(), sig_bytes, bitmap))
        return results

    def _backend_verify_batch(self, items, flags, results,
                              backend_calls, lane):
        """Sidecar remainder of a (possibly cross-epoch) batch: push
        any missing committees once, then pipeline EVERY check through
        the scheduler's backend worker — all frames on the wire before
        the first reply is awaited.  A failed pipelined call (sidecar
        restart mid-batch, unknown committee) falls back per-item to
        the resilient ``verify_header_signature`` path, which redials
        and replays committees."""
        from .. import sched

        for _, header, ctx, _ in backend_calls:
            self._ensure_backend_committee(ctx, header)
        futures = sched.backend_agg_verify_many(
            self.backend,
            [
                (header.epoch, header.shard_id, payload,
                 items[idx][2], items[idx][1])
                for idx, header, _, payload in backend_calls
            ],
            lane=sched.Lane.SYNC if lane is None else lane,
        )
        for (idx, header, _, _), fut in zip(backend_calls, futures):
            _, sig_bytes, bitmap = items[idx]
            try:
                ok = fut.result()
            except Exception:  # noqa: BLE001 — degrade per item to the
                # retrying per-header path; ITS failure propagates
                results[idx] = self.verify_header_signature(
                    header, sig_bytes, bitmap, flags[idx], lane=lane
                )
                continue
            if ok:
                results[idx] = True
                self._verified.put((header.hash(), sig_bytes, bitmap))
        return results
