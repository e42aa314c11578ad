"""Parallelism: the device mesh, its data-parallel and ensemble-member axes."""

from uncertainty_nerf_gs_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "shard_batch", "replicate"]
