"""Reconstruction-quality metrics: chamfer distance and F1 (torch, on the
tensors' device) and point-to-point / point-to-plane PSNR (numpy + scipy)."""

from rpcc_tpu_torch.metrics.chamfer import calc_chamfer_distance, nn_distances
from rpcc_tpu_torch.metrics.psnr import calc_point_to_point_plane_psnr, psnr

__all__ = ["calc_chamfer_distance", "calc_point_to_point_plane_psnr", "nn_distances", "psnr"]
