"""PGM (P5) / PPM (P6) image I/O, NumPy-backed.

Format contract follows the reference reader/writer
(src/V1/pnmio.c:46-109 header parsing with '#' comment skipping,
:166-230 binary reads, :232-333 writes): binary maxval-255 files,
dimensions capped at 10000.
"""

from __future__ import annotations

import numpy as np

_MAX_DIM = 10000


def _read_tokens(data: bytes, count: int) -> tuple[list[bytes], int]:
    """Read `count` whitespace-separated tokens, skipping '#' comments.
    Returns (tokens, offset past the single whitespace after the last)."""
    tokens = []
    i = 0
    n = len(data)
    while len(tokens) < count:
        while i < n and data[i:i + 1].isspace():
            i += 1
        if i < n and data[i] == ord('#'):
            while i < n and data[i] != ord('\n'):
                i += 1
            continue
        j = i
        while j < n and not data[j:j + 1].isspace():
            j += 1
        if j == i:
            raise ValueError("truncated PNM header")
        tokens.append(data[i:j])
        i = j
    return tokens, i + 1  # consume exactly one byte after the last token


def _parse_header(data: bytes, magic: bytes):
    tokens, offset = _read_tokens(data, 4)
    if tokens[0] != magic:
        raise ValueError(f"bad magic {tokens[0]!r}, expected {magic!r}")
    ncols, nrows, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if not (0 <= ncols <= _MAX_DIM and 0 <= nrows <= _MAX_DIM):
        raise ValueError(f"unacceptable dimensions {ncols}x{nrows}")
    if maxval != 255:
        raise ValueError(f"maxval must be 255, got {maxval}")
    return ncols, nrows, offset


def read_pgm(path: str) -> np.ndarray:
    """Read a binary PGM file -> uint8 [nrows, ncols]."""
    with open(path, "rb") as f:
        data = f.read()
    ncols, nrows, offset = _parse_header(data, b"P5")
    img = np.frombuffer(data, dtype=np.uint8, count=ncols * nrows,
                        offset=offset)
    return img.reshape(nrows, ncols).copy()


def write_pgm(path: str, img: np.ndarray) -> None:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    nrows, ncols = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{ncols} {nrows}\n255\n".encode())
        f.write(img.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read a binary PPM file -> uint8 [nrows, ncols, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    ncols, nrows, offset = _parse_header(data, b"P6")
    img = np.frombuffer(data, dtype=np.uint8, count=ncols * nrows * 3,
                        offset=offset)
    return img.reshape(nrows, ncols, 3).copy()


def write_ppm(path: str, rgb: np.ndarray) -> None:
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    nrows, ncols, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{ncols} {nrows}\n255\n".encode())
        f.write(rgb.tobytes())


def write_float_pgm(path: str, img: np.ndarray) -> None:
    """Min-max normalize a float image to uint8 and write PGM
    (reference: _KLTWriteFloatImageToPGM, src/V1/klt_util.c:95-130)."""
    img = np.asarray(img, dtype=np.float32)
    mmin, mmax = float(img.min()), float(img.max())
    fact = 255.0 / (mmax - mmin) if mmax > mmin else 0.0
    write_pgm(path, ((img - mmin) * fact).astype(np.uint8))
