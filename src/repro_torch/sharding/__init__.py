"""Sharding policies (logical-axis -> mesh-axis mapping, activation
redistribution, parameter specs), spec fitting and placement on a
``DeviceMesh``, and the collective-byte recorder."""

from repro_torch.sharding.policy import (
    FSDP_TP_POLICY,
    P,
    ShardingPolicy,
    TP_POLICY,
    shard_act,
)

__all__ = ["ShardingPolicy", "TP_POLICY", "FSDP_TP_POLICY", "P", "shard_act"]
