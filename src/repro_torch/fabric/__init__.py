"""``repro_torch.fabric`` — the memory-movement subsystem (port of
``repro.fabric``): the :class:`Fabric` networks, the :class:`BurstScheduler`
that multiplexes logical streams through one network call per burst, and
the :class:`PagedKVCache` page pool the serving engine stores KV in, with
its host swap space (:class:`SwapRecord`), and the sharded pool's host plan
(:func:`shard_plan`, :mod:`repro_torch.fabric.sharded`)."""

from repro_torch.configs.base import FabricConfig, PortSpec
from repro_torch.fabric.fabric import Fabric
from repro_torch.fabric.paged_kv import (PagedKVCache, PagePool, PageTable,
                                         SwapRecord)
from repro_torch.fabric.scheduler import (FRAME_SENTINEL, BurstScheduler,
                                          SchedulerStats)
from repro_torch.fabric.sharded import (ShardPlan, make_pool_mesh,
                                        pool_partition_spec, shard_plan)

__all__ = ["Fabric", "FabricConfig", "PortSpec", "BurstScheduler",
           "SchedulerStats", "PagedKVCache", "PagePool", "PageTable",
           "SwapRecord", "FRAME_SENTINEL", "ShardPlan", "shard_plan",
           "pool_partition_spec", "make_pool_mesh"]
