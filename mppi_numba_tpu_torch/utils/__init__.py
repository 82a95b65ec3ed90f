from .angles import normalize_angle, normalize_angle_np, normalize_angle_torch

__all__ = ["normalize_angle", "normalize_angle_np", "normalize_angle_torch"]
