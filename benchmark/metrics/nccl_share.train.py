"""Mesh layer: NCCL's kernels' device time over all device-busy time of
the traced train epochs, rank 0, in percent."""

from benchmark.mesh import nccl_share


def read(rec: dict):
    return nccl_share(rec, "train")
