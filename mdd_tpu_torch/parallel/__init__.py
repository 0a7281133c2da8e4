"""Data parallelism over torch.distributed (mesh.py)."""

from mdd_tpu_torch.parallel.mesh import all_reduce_metrics
