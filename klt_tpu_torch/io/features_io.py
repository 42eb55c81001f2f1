"""Feature list / history / table persistence.

Produces and consumes the reference's exact on-disk formats
(src/V1/writeFeatures.c): binary files with KLTFL1 / KLTFH1 / KLTFT1 magic
followed by little-endian int32 counts and packed (float32 x, float32 y,
int32 val) records (:294-301, :326-443), and the human-readable text
tables with comment preamble + warning line (:217-269).  Byte-for-byte
compatible with files produced by the reference, which is the golden
fixture contract for tests/ and the checkpoint format for long runs.
"""

from __future__ import annotations

import io as _io
import re
import struct

import numpy as np

from ..features import FeatureList, FeatureHistory, FeatureTable

_MAGIC_FL = b"KLTFL1"
_MAGIC_FH = b"KLTFH1"
_MAGIC_FT = b"KLTFT1"

_WARNING_LINE = ("!!! Warning:  This is a KLT data file.  "
                 "Do not modify below this line !!!\n")
_BANG_LINE = "!" * 73 + "\n"


# --------------------------------------------------------------------- #
# text helpers                                                          #
# --------------------------------------------------------------------- #

def _expanded_width(fmt: str) -> int:
    """Printed width of one '(fmt,fmt)=%5d ' record
    (reference: _findStringWidth, src/V1/writeFeatures.c:179-214)."""
    record = f"({fmt},{fmt})=%5d "
    width = 0
    i = 0
    while i < len(record):
        if record[i] == "%":
            m = re.match(r"%(\d+)", record[i:])
            if not m:
                raise ValueError(f"bad format {fmt!r}")
            width += int(m.group(1))
            i += len(m.group(0))
            while record[i] not in "diouxefgn":
                i += 1
            i += 1
        else:
            width += 1
            i += 1
    return width


def _format_feature(fmt: str, x: float, y: float, val: int) -> str:
    """One text record, matching C printf semantics for %W.Pf / %Wd."""
    kind = fmt[-1]
    if kind == "f":
        m = re.match(r"%(\d+)\.(\d+)f", fmt)
        w, p = int(m.group(1)), int(m.group(2))
        return f"({x:{w}.{p}f},{y:{w}.{p}f})={val:5d} "
    if kind == "d":
        m = re.match(r"%(\d+)d", fmt)
        w = int(m.group(1))
        # round-to-nearest for non-negative, truncate otherwise
        # (reference: _printFeatureTxt, src/V1/writeFeatures.c:282-290)
        xi = int(x + 0.5) if x >= 0.0 else int(x)
        yi = int(y + 0.5) if y >= 0.0 else int(y)
        return f"({xi:{w}d},{yi:{w}d})={val:5d} "
    raise ValueError("format must end in 'f' or 'd'")


def _text_header(kind: str, n_frames: int, n_features: int,
                 fmt: str) -> str:
    width = _expanded_width(fmt)
    out = _io.StringIO()
    out.write("Feel free to place comments here.\n\n\n")
    out.write(_BANG_LINE)
    out.write(_WARNING_LINE)
    out.write("\n")
    out.write("-" * 30 + "\n")
    title = {"list": "KLT Feature List", "history": "KLT Feature History",
             "table": "KLT Feature Table"}[kind]
    out.write(title + "\n")
    out.write("-" * 30 + "\n\n")
    if kind == "list":
        out.write(f"nFeatures = {n_features}\n\n")
        out.write("feature | (x,y)=val\n")
        out.write("--------+-" + "-" * width + "\n")
    elif kind == "history":
        out.write(f"nFrames = {n_frames}\n\n")
        out.write("frame | (x,y)=val\n")
        out.write("------+-" + "-" * width + "\n")
    else:
        out.write(f"nFrames = {n_frames}, nFeatures = {n_features}\n\n")
        out.write("feature |          frame\n")
        out.write("        |")
        for i in range(n_frames):
            out.write(f"{i:{width}d}")
        out.write("\n--------+-" + "-" * (width * n_frames) + "\n")
    return out.getvalue()


# --------------------------------------------------------------------- #
# writers                                                               #
# --------------------------------------------------------------------- #

def _write_records_bin(f, x: np.ndarray, y: np.ndarray,
                       val: np.ndarray) -> None:
    rec = np.empty((x.size, 3), dtype="<f4")
    rec[:, 0] = x.ravel()
    rec[:, 1] = y.ravel()
    rec[:, 2] = val.ravel().astype(np.int32).view(np.float32)
    f.write(rec.tobytes())


def write_feature_list(fl: FeatureList, path: str,
                       fmt: str | None = None) -> None:
    if fmt is None:
        with open(path, "wb") as f:
            f.write(_MAGIC_FL)
            f.write(struct.pack("<i", fl.n_features))
            _write_records_bin(f, fl.x, fl.y, fl.val)
        return
    with open(path, "w", newline="") as f:
        f.write(_text_header("list", 0, fl.n_features, fmt))
        for i in range(fl.n_features):
            f.write(f"{i:7d} | ")
            f.write(_format_feature(fmt, float(fl.x[i]), float(fl.y[i]),
                                    int(fl.val[i])))
            f.write("\n")


def write_feature_history(fh: FeatureHistory, path: str,
                          fmt: str | None = None) -> None:
    if fmt is None:
        with open(path, "wb") as f:
            f.write(_MAGIC_FH)
            f.write(struct.pack("<i", fh.n_frames))
            _write_records_bin(f, fh.x, fh.y, fh.val)
        return
    with open(path, "w", newline="") as f:
        f.write(_text_header("history", fh.n_frames, 0, fmt))
        for i in range(fh.n_frames):
            f.write(f"{i:5d} | ")
            f.write(_format_feature(fmt, float(fh.x[i]), float(fh.y[i]),
                                    int(fh.val[i])))
            f.write("\n")


def write_feature_table(ft: FeatureTable, path: str,
                        fmt: str | None = None) -> None:
    if fmt is None:
        with open(path, "wb") as f:
            f.write(_MAGIC_FT)
            f.write(struct.pack("<ii", ft.n_frames, ft.n_features))
            _write_records_bin(f, ft.x, ft.y, ft.val)
        return
    with open(path, "w", newline="") as f:
        f.write(_text_header("table", ft.n_frames, ft.n_features, fmt))
        for j in range(ft.n_features):
            f.write(f"{j:7d} | ")
            for i in range(ft.n_frames):
                f.write(_format_feature(fmt, float(ft.x[j, i]),
                                        float(ft.y[j, i]),
                                        int(ft.val[j, i])))
            f.write("\n")


# --------------------------------------------------------------------- #
# readers                                                               #
# --------------------------------------------------------------------- #

_RECORD_RE = re.compile(
    rb"\(\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*\)\s*=\s*(-?\d+)")


def _read_records_bin(data: bytes, offset: int, n: int):
    rec = np.frombuffer(data, dtype="<f4", count=3 * n,
                        offset=offset).reshape(n, 3)
    x = rec[:, 0].copy()
    y = rec[:, 1].copy()
    val = rec[:, 2].copy().view("<i4").astype(np.int32)
    return x, y, val


def _read_records_txt(data: bytes, n: int):
    matches = _RECORD_RE.findall(data)
    if len(matches) < n:
        raise ValueError(f"expected {n} records, found {len(matches)}")
    x = np.array([float(m[0]) for m in matches[:n]], np.float32)
    y = np.array([float(m[1]) for m in matches[:n]], np.float32)
    val = np.array([int(m[2]) for m in matches[:n]], np.int32)
    return x, y, val


def _read_txt_header_counts(data: bytes) -> dict[str, int]:
    out = {}
    m = re.search(rb"nFeatures\s*=\s*(\d+)", data)
    if m:
        out["nFeatures"] = int(m.group(1))
    m = re.search(rb"nFrames\s*=\s*(\d+)", data)
    if m:
        out["nFrames"] = int(m.group(1))
    return out


def read_feature_list(path: str) -> FeatureList:
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] == _MAGIC_FL:
        (n,) = struct.unpack_from("<i", data, 6)
        x, y, val = _read_records_bin(data, 10, n)
    else:
        if _WARNING_LINE.encode() not in data:
            raise ValueError("not a KLT data file")
        n = _read_txt_header_counts(data)["nFeatures"]
        x, y, val = _read_records_txt(data, n)
    return FeatureList(x, y, val)


def read_feature_history(path: str) -> FeatureHistory:
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] == _MAGIC_FH:
        (n,) = struct.unpack_from("<i", data, 6)
        x, y, val = _read_records_bin(data, 10, n)
    else:
        if _WARNING_LINE.encode() not in data:
            raise ValueError("not a KLT data file")
        n = _read_txt_header_counts(data)["nFrames"]
        x, y, val = _read_records_txt(data, n)
    return FeatureHistory(x, y, val)


def read_feature_table(path: str) -> FeatureTable:
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] == _MAGIC_FT:
        n_frames, n_features = struct.unpack_from("<ii", data, 6)
        x, y, val = _read_records_bin(data, 14, n_frames * n_features)
    else:
        if _WARNING_LINE.encode() not in data:
            raise ValueError("not a KLT data file")
        counts = _read_txt_header_counts(data)
        n_frames, n_features = counts["nFrames"], counts["nFeatures"]
        # skip the frame-index header integers before the records
        x, y, val = _read_records_txt(data, n_frames * n_features)
    shape = (n_features, n_frames)
    return FeatureTable(x.reshape(shape), y.reshape(shape),
                        val.reshape(shape))
