"""Correctly rounded f32 operations on every device.

The kernels (built without fast math) and the C reference compute sqrt
as the IEEE operation, correctly rounded.  So does PyTorch on a CUDA
device, but its CPU sqrt goes through a vectorised approximation that
can land one ulp off; numpy's float32 sqrt is the IEEE operation.  The
plain versions take their square roots from here, so that they equal the
kernels on the card and on the CPU alike.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root of an f32 tensor, correctly rounded on any device."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)
