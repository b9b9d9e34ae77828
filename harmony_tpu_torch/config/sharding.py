"""Sharding schedules: per-epoch network topology.

Behavioral parity with the reference's shardingconfig (reference:
internal/configs/sharding/shardingconfig.go — Schedule/Instance;
mainnet.go:70-140 epoch->instance switching, :364-389 instance data):
an Instance fixes shard count, slots per shard, Harmony-operated slot
count and the Harmony vote share; a Schedule maps an epoch to the
Instance active at that epoch (thresholds ascending, last one wins).

The port's copy of the JAX package's ``config/sharding.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..numeric import Dec, one_dec


@dataclass(frozen=True)
class Instance:
    num_shards: int
    slots_per_shard: int
    harmony_nodes_per_shard: int
    harmony_vote_percent: Dec
    # genesis-account table names (config/genesis_accounts.py) feeding
    # the pre-staking committee assembly (reference: Instance
    # hmyAccounts/fnAccounts); None = dev chain, keys generated
    hmy_accounts_table: str | None = None
    fn_accounts_table: str | None = None
    # HIP-16 per-validator slot limit as a fraction of external slots
    # (reference: Instance.SlotsLimit, 0 = unlimited)
    slots_limit_fraction: float = 0.0

    def external_slots_per_shard(self) -> int:
        return self.slots_per_shard - self.harmony_nodes_per_shard

    def external_vote_percent(self) -> Dec:
        return one_dec().sub(self.harmony_vote_percent)

    def total_slots(self) -> int:
        return self.num_shards * self.slots_per_shard

    def slots_limit(self) -> int:
        """HIP-16 absolute cap per validator (reference:
        shardingconfig SlotsLimit = fraction * external slots)."""
        return int(self.slots_limit_fraction
                   * self.external_slots_per_shard())


class Schedule:
    """Epoch -> Instance lookup over ascending thresholds."""

    def __init__(self, instances: list):
        """instances: [(first_epoch, Instance)] with ascending epochs."""
        if not instances:
            raise ValueError("empty schedule")
        epochs = [e for e, _ in instances]
        if epochs != sorted(epochs) or epochs[0] != 0:
            raise ValueError("schedule must start at epoch 0, ascending")
        self._instances = list(instances)

    def instance_for_epoch(self, epoch: int) -> Instance:
        chosen = self._instances[0][1]
        for first, inst in self._instances:
            if epoch >= first:
                chosen = inst
            else:
                break
        return chosen


def _m(shards, slots, hmy, pct, fn_table, hmy_table="HarmonyAccounts",
       slots_limit=0.0):
    return Instance(
        shards, slots, hmy, Dec.from_str(pct),
        hmy_accounts_table=hmy_table, fn_accounts_table=fn_table,
        slots_limit_fraction=slots_limit,
    )


# THE mainnet schedule, every era transcribed (reference:
# internal/configs/sharding/mainnet.go — mainnetV0..mainnetV5 instance
# data :238-372, epoch dispatch :73-137; era thresholds :22-35 plus the
# TwoSeconds/SixtyPercent/HIP6And8/SlotsLimited/FeeCollect/HIP30/HIP32
# gates from internal/params/config.go's MainnetChainConfig).
MAINNET = Schedule(
    [
        (0, _m(4, 150, 112, "1.0", "FoundationalNodeAccounts")),
        (1, _m(4, 152, 112, "1.0", "FoundationalNodeAccountsV0_1")),
        (5, _m(4, 200, 148, "1.0", "FoundationalNodeAccountsV0_2")),
        (8, _m(4, 210, 148, "1.0", "FoundationalNodeAccountsV0_3")),
        (10, _m(4, 216, 148, "1.0", "FoundationalNodeAccountsV0_4")),
        (12, _m(4, 250, 170, "1.0", "FoundationalNodeAccountsV1")),
        (19, _m(4, 250, 170, "1.0", "FoundationalNodeAccountsV1_1")),
        (25, _m(4, 250, 170, "1.0", "FoundationalNodeAccountsV1_2")),
        (36, _m(4, 250, 170, "1.0", "FoundationalNodeAccountsV1_3")),
        (46, _m(4, 250, 170, "1.0", "FoundationalNodeAccountsV1_4")),
        (54, _m(4, 250, 170, "1.0", "FoundationalNodeAccountsV1_5")),
        (185, _m(4, 250, 170, "0.68", "FoundationalNodeAccountsV1_5")),
        (208, _m(4, 250, 130, "0.68", "FoundationalNodeAccountsV1_5")),
        (231, _m(4, 250, 90, "0.68", "FoundationalNodeAccountsV1_5")),
        # 366 = TwoSecondsEpoch (mainnetV3: same shape as V2_2)
        (366, _m(4, 250, 90, "0.68", "FoundationalNodeAccountsV1_5")),
        # 530 = SixtyPercentEpoch (mainnetV3_1)
        (530, _m(4, 250, 50, "0.60", "FoundationalNodeAccountsV1_5")),
        # 725 = HIP6And8Epoch (mainnetV3_2)
        (725, _m(4, 250, 25, "0.49", "FoundationalNodeAccountsV1_5")),
        # 999 = SlotsLimitedEpoch (mainnetV3_3: HIP-16 cap 0.06)
        (999, _m(4, 250, 25, "0.49", "FoundationalNodeAccountsV1_5",
                 slots_limit=0.06)),
        # 1535 = FeeCollectEpoch (mainnetV3_4: fee collectors added,
        # committee shape unchanged)
        (1535, _m(4, 250, 25, "0.49", "FoundationalNodeAccountsV1_5",
                  slots_limit=0.06)),
        # 1673 = HIP30Epoch (mainnetV4: 2 shards, post-HIP30 accounts)
        (1673, _m(2, 200, 20, "0.49", "FoundationalNodeAccountsV1_5",
                  hmy_table="HarmonyAccountsPostHIP30",
                  slots_limit=0.06)),
        # 2152 = HIP32Epoch (mainnetV5: internal share 0.01)
        (2152, _m(2, 200, 2, "0.01", "FoundationalNodeAccountsV1_5",
                  hmy_table="HarmonyAccountsPostHIP30",
                  slots_limit=0.06)),
    ]
)

# Back-compat alias (pre-round-5 name; same trajectory, now exact)
MAINNET_LIKE = MAINNET

LOCALNET = Schedule(
    [(0, Instance(2, 10, 5, Dec.from_str("0.68")))]
)
