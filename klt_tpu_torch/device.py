"""Where an entry point runs when its caller does not say.

The port is written for the card: an entry point that is handed numpy
arrays, or no device, runs on the CUDA device and raises without one.  The
CPU (the plain torch versions) is taken only when the caller asks for it
by name, or hands over tensors that already lie there.
"""

from __future__ import annotations

import torch


def default_device(device: str | torch.device | None = None) -> torch.device:
    """`device` if given, else the CUDA device; raises when that is
    asked for by default and there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: klt_tpu_torch runs on the card by default; "
            "pass device=\"cpu\" to run the plain torch versions on the CPU")
    return torch.device("cuda")
