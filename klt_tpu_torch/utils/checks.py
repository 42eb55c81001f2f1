"""Debug-mode runtime checks (the reference's assert set, §4.3).

The C library compiles its asserts out with -DNDEBUG (src/V1/Makefile:9);
here the equivalent guards run only when KLT_TPU_DEBUG=1, the switch
klt_tpu reads, so the production path pays nothing: with debug off each
check returns before it touches a tensor (no launch, no host sync).  With
debug on, a check reduces its tensors on their device to one flag and
reads that flag once; a failed check warns through `errors.klt_warning`.
Inside `collecting(flags)` (the sequence entries' chunks, which a CUDA
graph may capture, where no host read is allowed) a check reads nothing:
it ORs its flag into `flags` on the device, and `flags.report()` reads
them all once, after the call, one warning per failed check (as
klt_tpu's checks fire from inside its scans).  Covered asserts:

* in-bounds interpolation coordinates (src/V1/trackFeatures.c:51)
* image-size compatibility between convolution operands
  (src/V1/convolve.c:46-47)
* finite feature positions after tracking
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch

from ..errors import klt_warning


def debug_enabled() -> bool:
    return os.environ.get("KLT_TPU_DEBUG", "0") == "1"


def check_in_bounds(x, y, ncols: int, nrows: int, what: str = "coords"):
    """Warns when any (x, y) lies outside [0, ncols-1] x [0, nrows-1]
    (debug mode only)."""
    if not debug_enabled():
        return
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    if x.shape != y.shape:
        raise ValueError(f"{what}: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} differ in shape")
    _warn_if(torch.any((x < 0) | (x > ncols - 1) | (y < 0) |
                       (y > nrows - 1)), what)


def check_same_shape(a, b, what: str = "images"):
    """Warns when a and b differ in shape (debug mode only)."""
    if not debug_enabled():
        return
    if tuple(a.shape) != tuple(b.shape):
        klt_warning(f"debug check failed: {what} mismatch: "
                    f"{tuple(a.shape)} vs {tuple(b.shape)}")


def check_finite(arr, what: str = "values"):
    """Warns when arr holds a NaN or an infinity (debug mode only)."""
    if not debug_enabled():
        return
    _warn_if(torch.any(~torch.isfinite(torch.as_tensor(arr))), what)


class Flags:
    """The failed-check flags of a call, bool tensors on the device by
    check (`what`), ORed over the steps."""

    def __init__(self):
        self.bad: dict[str, torch.Tensor] = {}

    def add(self, what: str, bad: torch.Tensor) -> None:
        prev = self.bad.get(what)
        self.bad[what] = bad if prev is None else prev | bad

    def merge(self, other: "Flags") -> None:
        """OR in another set's flags (a replayed graph's, which its next
        replay overwrites: the first is copied)."""
        for what, bad in other.bad.items():
            prev = self.bad.get(what)
            self.bad[what] = bad.clone() if prev is None else prev | bad

    def report(self) -> None:
        """One host read for all the flags, then klt_tpu's warning for
        each failed check."""
        if not self.bad:
            return
        failed = torch.stack([b.reshape(()) for b in self.bad.values()])
        for what, bad in zip(self.bad, failed.tolist()):
            if bad:
                _warn(what)
        self.bad.clear()


_collector: contextvars.ContextVar = contextvars.ContextVar(
    "klt_check_flags", default=None)


@contextlib.contextmanager
def collecting(flags: Flags):
    """The checks inside OR their flags into `flags` instead of reading
    them."""
    token = _collector.set(flags)
    try:
        yield flags
    finally:
        _collector.reset(token)


def _warn(what: str) -> None:
    """klt_tpu's message, " out of bounds" for every check of a flag."""
    klt_warning(f"debug check failed: {what} out of bounds")


def _warn_if(bad: torch.Tensor, what: str) -> None:
    flags = _collector.get()
    if flags is not None:
        flags.add(what, bad)
    elif bool(bad):   # the check's one host read
        _warn(what)
