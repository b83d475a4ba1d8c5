"""``repro_torch.parallel`` — the parallelism of the port (port of
``repro.parallel``), every rank on the run's one device, in one process:
the collectives over lists of per-rank tensors (the all-to-all, the
all-gather, the int8 all-reduce and the data-parallel gradient mean), the
logical-axis :class:`Sharder` and its rules, and the microbatch
pipeline."""

from repro_torch.parallel.collectives import (compressed_psum, dp_grad_mean,
                                              ring_all_gather,
                                              ring_all_to_all,
                                              xla_all_to_all)
from repro_torch.parallel.pipeline import (bubble_fraction, pipeline_forward,
                                           pipeline_loss)
from repro_torch.parallel.sharding import (LOGICAL_RULES_SP,
                                           LOGICAL_RULES_TP, Sharder,
                                           current_sharder, no_sharding,
                                           rules_for, set_sharder, shard,
                                           use_sharder)

__all__ = ["ring_all_to_all", "xla_all_to_all", "ring_all_gather",
           "compressed_psum", "dp_grad_mean", "Sharder", "rules_for",
           "LOGICAL_RULES_TP", "LOGICAL_RULES_SP", "shard", "set_sharder",
           "use_sharder", "current_sharder", "no_sharding",
           "pipeline_forward", "pipeline_loss", "bubble_fraction"]
