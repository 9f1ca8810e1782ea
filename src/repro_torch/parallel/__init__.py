from .axes import ShardingRules, current_ctx, logical_spec, shard, sharding_ctx

__all__ = ["ShardingRules", "current_ctx", "logical_spec", "shard", "sharding_ctx"]
