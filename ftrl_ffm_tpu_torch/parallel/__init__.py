"""Meshes for ftrl_ffm_tpu_torch (ftrl_ffm_tpu/parallel): one process a
device, a ("data", "model") grid of ranks over torch.distributed (NCCL on
the card, gloo on the CPU).

  * "data"  — the global batch is split over it (data parallel);
  * "model" — the feature tables are row-sharded over it with
    modulo-interleaved rows (the parameter-server analogue).

parallel/dist.py joins the group and counts the collectives,
parallel/mesh.py builds the grid and places a state on it, and
parallel/sharded.py runs the sharded train and eval steps.
"""

from ftrl_ffm_tpu_torch.parallel.mesh import (
    init_shard,
    make_mesh,
    place_state,
    shard_state,
    unshard_state,
)
from ftrl_ffm_tpu_torch.parallel.sharded import ShardedStep

__all__ = ["init_shard", "make_mesh", "place_state", "shard_state", "unshard_state",
           "ShardedStep"]
