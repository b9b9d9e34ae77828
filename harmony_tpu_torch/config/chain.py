"""Epoch-gated chain configuration.

Behavioral parity with the reference's ChainConfig (reference:
internal/params/config.go:480-780): every protocol upgrade is an epoch
threshold; a feature is active in epoch e iff its threshold is set and
<= e.  It carries the reference's FULL gate table as data (all
~40 mainnet thresholds transcribed from config.go's
MainnetChainConfig), so a node can be configured "mainnet-shaped";
the subset the device pipeline consumes has dedicated accessors, the
rest answer through ``is_active(name, epoch)``.

EPOCH_TBD mirrors the reference's far-future placeholder for gates not
yet scheduled (internal/params/config.go:33).

The port's copy of the JAX package's ``config/chain.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

EPOCH_TBD = 10_000_000  # reference: params.EpochTBD

# Harmony-network chain ids (reference: config.go:13-31)
MAINNET_CHAIN_ID = 1
TESTNET_CHAIN_ID = 2
ETH_MAINNET_SHARD0_CHAIN_ID = 1666600000
ETH_TESTNET_SHARD0_CHAIN_ID = 1666700000


@dataclass
class ChainConfig:
    chain_id: int = 1
    eth_compatible_chain_id: int = 1
    # ---- gates the pipeline consumes (dedicated accessors) ----------
    staking_epoch: int | None = 0  # reference: IsStaking (config.go:724)
    two_seconds_epoch: int | None = 0  # block time 2s (config.go:740)
    leader_rotation_epoch: int | None = None
    epos_bound_v2_epoch: int | None = None  # extended 0.35 EPoS bound
    cross_shard_epoch: int | None = 0
    # header version thresholds (reference: the block factory picks the
    # header version by epoch via internal/params gates feeding
    # block/factory; v0 is the genesis-era legacy encoding)
    header_v1_epoch: int | None = 0
    header_v2_epoch: int | None = 0
    header_v3_epoch: int | None = 0
    # MPT state root in headers (reference: headers always commit the
    # secure-trie root, core/state; gated here so legacy flat-root
    # chains replay)
    mpt_root_epoch: int | None = 0
    # ---- the rest of the reference's gate table, as data ------------
    # (names mirror config.go's fields, snake_cased; consumed through
    # is_active() until a subsystem grows a dedicated call site)
    eth_compatible_epoch: int | None = 0
    cross_link_epoch: int | None = 0
    aggregated_reward_epoch: int | None = 0
    pre_staking_epoch: int | None = 0
    quick_unlock_epoch: int | None = 0
    five_seconds_epoch: int | None = 0
    sixty_percent_epoch: int | None = 0
    redelegation_epoch: int | None = 0
    no_early_unlock_epoch: int | None = 0
    # VRF proposals are opt-in (a proposer must PRODUCE proofs once
    # gated): default off for dev chains, mainnet gates at 631/689
    vrf_epoch: int | None = None
    prev_vrf_epoch: int | None = None
    min_delegation_100_epoch: int | None = 0
    min_commission_rate_epoch: int | None = 0
    min_commission_promo_period: int = 100
    eip155_epoch: int | None = 0
    s3_epoch: int | None = 0
    data_copy_fix_epoch: int | None = 0
    istanbul_epoch: int | None = 0
    receipt_log_epoch: int | None = 0
    sha3_epoch: int | None = 0
    hip6and8_epoch: int | None = 0
    staking_precompile_epoch: int | None = 0
    chain_id_fix_epoch: int | None = 0
    slots_limited_epoch: int | None = None
    cross_shard_xfer_precompile_epoch: int | None = 0
    allowlist_epoch: int | None = None
    leader_rotation_v2_epoch: int | None = None
    fee_collect_epoch: int | None = None
    validator_code_fix_epoch: int | None = 0
    hip30_epoch: int | None = None
    block_gas_30m_epoch: int | None = None
    max_rate_epoch: int | None = None
    top_max_rate_epoch: int | None = None
    hip32_epoch: int | None = None
    one_second_epoch: int | None = None
    devnet_external_epoch: int | None = None
    testnet_external_epoch: int | None = None
    extra: dict = field(default_factory=dict)  # name -> epoch threshold

    @staticmethod
    def _active(threshold: int | None, epoch: int) -> bool:
        return threshold is not None and epoch >= threshold

    def is_staking(self, epoch: int) -> bool:
        return self._active(self.staking_epoch, epoch)

    def is_two_seconds(self, epoch: int) -> bool:
        return self._active(self.two_seconds_epoch, epoch)

    def is_leader_rotation(self, epoch: int) -> bool:
        return self._active(self.leader_rotation_epoch, epoch)

    def is_epos_bound_v2(self, epoch: int) -> bool:
        return self._active(self.epos_bound_v2_epoch, epoch)

    def is_cross_shard(self, epoch: int) -> bool:
        return self._active(self.cross_shard_epoch, epoch)

    def accepts_cross_tx(self, epoch: int) -> bool:
        """Cross-shard txs are ACCEPTED one epoch after the fields gate
        (reference: AcceptsCrossTx, config.go:703-707 — every shard
        must roll into the epoch before clients may submit)."""
        return (self.cross_shard_epoch is not None
                and epoch >= self.cross_shard_epoch + 1)

    def header_version(self, epoch: int) -> str:
        """The header version new proposals use at this epoch."""
        for ver, thr in (("v3", self.header_v3_epoch),
                         ("v2", self.header_v2_epoch),
                         ("v1", self.header_v1_epoch)):
            if self._active(thr, epoch):
                return ver
        return "v0"

    def is_mpt_root(self, epoch: int) -> bool:
        return self._active(self.mpt_root_epoch, epoch)

    def state_root(self, state, epoch: int) -> bytes:
        """The root headers commit at this epoch: the secure-trie MPT
        root once gated (reference semantics), else the legacy flat
        root."""
        return state.mpt_root() if self.is_mpt_root(epoch) else state.root()

    def is_active(self, name: str, epoch: int) -> bool:
        """Generic gate lookup: any ``*_epoch`` field by short name
        (``is_active("istanbul", e)``); an explicit ``extra`` entry
        overrides the field (operator config wins)."""
        if name in self.extra:
            return self._active(self.extra[name], epoch)
        attr = name if name.endswith("_epoch") else name + "_epoch"
        if hasattr(self, attr):
            return self._active(getattr(self, attr), epoch)
        return False

    def gate_table(self) -> dict:
        """Every threshold as {name: epoch|None} — operator/debug
        surface (hmy facade, config dumps)."""
        out = {}
        for f in fields(self):
            if f.name.endswith("_epoch"):
                out[f.name[:-6]] = getattr(self, f.name)
        out.update(self.extra)
        return out


def mainnet_config() -> ChainConfig:
    """The mainnet-shaped gate table (reference: MainnetChainConfig,
    internal/params/config.go:38-87 — every threshold transcribed)."""
    return ChainConfig(
        chain_id=MAINNET_CHAIN_ID,
        eth_compatible_chain_id=ETH_MAINNET_SHARD0_CHAIN_ID,
        # consumed-gate mappings: ours <- reference name
        staking_epoch=186,                 # StakingEpoch
        two_seconds_epoch=366,             # TwoSecondsEpoch
        leader_rotation_epoch=2152,        # LeaderRotationInternal/External
        epos_bound_v2_epoch=631,           # EPoSBound35Epoch
        cross_shard_epoch=28,              # CrossTxEpoch
        # full table
        eth_compatible_epoch=442,
        cross_link_epoch=186,
        aggregated_reward_epoch=689,
        pre_staking_epoch=185,
        quick_unlock_epoch=191,
        five_seconds_epoch=230,
        sixty_percent_epoch=530,
        redelegation_epoch=290,
        no_early_unlock_epoch=530,
        vrf_epoch=631,
        prev_vrf_epoch=689,
        min_delegation_100_epoch=631,
        min_commission_rate_epoch=631,
        min_commission_promo_period=100,
        eip155_epoch=28,
        s3_epoch=28,
        data_copy_fix_epoch=689,
        istanbul_epoch=314,
        receipt_log_epoch=101,
        sha3_epoch=725,
        hip6and8_epoch=725,
        staking_precompile_epoch=871,
        chain_id_fix_epoch=1323,
        slots_limited_epoch=999,
        cross_shard_xfer_precompile_epoch=1323,
        allowlist_epoch=EPOCH_TBD,
        leader_rotation_v2_epoch=EPOCH_TBD,
        fee_collect_epoch=1535,
        validator_code_fix_epoch=1535,
        hip30_epoch=1673,
        block_gas_30m_epoch=1673,
        max_rate_epoch=1733,
        top_max_rate_epoch=1976,
        hip32_epoch=2152,
        one_second_epoch=EPOCH_TBD,
        devnet_external_epoch=EPOCH_TBD,
        testnet_external_epoch=EPOCH_TBD,
    )


def testnet_config() -> ChainConfig:
    """Testnet gate table (reference: TestnetChainConfig — most gates
    open at 0; the handful of later thresholds transcribed)."""
    cfg = ChainConfig(
        chain_id=TESTNET_CHAIN_ID,
        eth_compatible_chain_id=ETH_TESTNET_SHARD0_CHAIN_ID,
        staking_epoch=2,
        two_seconds_epoch=0,
        leader_rotation_epoch=EPOCH_TBD,
        epos_bound_v2_epoch=0,
        cross_shard_epoch=0,
        pre_staking_epoch=1,
    )
    cfg.allowlist_epoch = EPOCH_TBD
    cfg.leader_rotation_v2_epoch = EPOCH_TBD
    cfg.one_second_epoch = EPOCH_TBD
    return cfg
