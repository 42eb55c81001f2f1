from .convolve import (convolve_separable, compute_smoothed_image,
                       compute_gradients)
from .pyramid import build_image_pyramids, build_pyramid_stacks
from .interp import bilinear_sample, sample_stack_windows
from .selection import candidate_points
from .lk import track_features_pyramid, track_features_pyramid_stacks

__all__ = [
    "convolve_separable", "compute_smoothed_image", "compute_gradients",
    "build_image_pyramids", "build_pyramid_stacks",
    "bilinear_sample", "sample_stack_windows", "candidate_points",
    "track_features_pyramid", "track_features_pyramid_stacks",
]
