"""``repro_torch.parallel`` — the collectives of the sharded page pool
(port of ``repro.parallel.collectives``'s all-to-all and all-gather), over
lists of per-shard tensors in one process.  The training parallelism
(``sharding``, ``pipeline``, ``compressed_psum``, ``dp_grad_mean``) is
ROADMAP §1 item 8b."""

from repro_torch.parallel.collectives import (ring_all_gather,
                                              ring_all_to_all,
                                              xla_all_to_all)

__all__ = ["ring_all_to_all", "xla_all_to_all", "ring_all_gather"]
