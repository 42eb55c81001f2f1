from .convolve import (convolve_separable, compute_smoothed_image,
                       compute_gradients, to_float_image)
from .pyramid import (build_pyramid, build_image_pyramids,
                      build_pyramid_stacks, build_pyramid_stacks_batched)
from .interp import (bilinear_sample, window_offsets, sample_stack_at,
                     sample_stack_windows)
from .selection import candidate_points, corner_response
from .lk import track_features_pyramid, track_features_pyramid_stacks
from .replace import replace_lost_features_device

__all__ = [
    "convolve_separable", "compute_smoothed_image", "compute_gradients",
    "to_float_image", "build_pyramid", "build_image_pyramids",
    "build_pyramid_stacks", "build_pyramid_stacks_batched",
    "bilinear_sample", "window_offsets", "sample_stack_at",
    "sample_stack_windows", "candidate_points", "corner_response",
    "track_features_pyramid", "track_features_pyramid_stacks",
    "replace_lost_features_device",
]
