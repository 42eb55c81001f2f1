"""Error/warning surface (reference: error.c, src/V1/error.c:23-56).

The C library's KLTError printf-and-exits; here it raises, and KLTWarning
routes through the warnings machinery so callers can filter.  Kept as a
dedicated module so reference users find the familiar names.
"""

from __future__ import annotations

import warnings


class KLTError(RuntimeError):
    """Fatal tracker error (reference: KLTError, src/V1/error.c:23-35 —
    which printed and exit(1)'d; here it raises)."""


class KLTWarningCategory(UserWarning):
    """Category for KLT warnings so callers can filter them."""


def klt_warning(msg: str) -> None:
    """Non-fatal warning (reference: KLTWarning, src/V1/error.c:45-56)."""
    warnings.warn(msg, KLTWarningCategory, stacklevel=2)
