"""PGM image-sequence datasets.

Counterpart of klt_tpu/io/dataset.py: loads the reference benchmark
sequences (images_provided: img0..img9; images_traffic: img1..img551;
images_laptops: img1..img1003) from a data root — the directory named by
KLT_DATA_ROOT (the variable klt_tpu reads), else `data/` at the root of
the checkout.  `download_dataset` fetches a benchmark sequence by name;
nothing else here touches the network.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .._build import repo_path
from .pnm import read_pgm


def _roots() -> tuple[str, ...]:
    return (os.environ.get("KLT_DATA_ROOT", ""), repo_path("data"))


def find_dataset(name: str) -> str | None:
    """Locate a dataset directory by name, or None if unavailable."""
    for root in _roots():
        if not root:
            continue
        path = os.path.join(root, name)
        if os.path.isdir(path):
            return path
    return None


class ImageSequence:
    """Lazy PGM frame sequence (imgN.pgm) in numeric order."""

    def __init__(self, directory: str):
        self.directory = directory
        pat = re.compile(r"img(\d+)\.pgm$")
        frames = []
        for fname in os.listdir(directory):
            m = pat.match(fname)
            if m:
                frames.append((int(m.group(1)), fname))
        frames.sort()
        if not frames:
            raise FileNotFoundError(f"no imgN.pgm frames in {directory}")
        self._files = [f for _, f in frames]
        self.indices = [i for i, _ in frames]
        first = self[0]
        self.nrows, self.ncols = first.shape

    def __len__(self) -> int:
        return len(self._files)

    def __getitem__(self, i: int) -> np.ndarray:
        return read_pgm(os.path.join(self.directory, self._files[i]))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def paths(self, n: int | None = None) -> list[str]:
        """The first n frames' file paths (all by default)."""
        return [os.path.join(self.directory, f) for f in self._files[:n]]


def load_sequence(name: str, max_frames: int | None = None):
    """Dataset name -> list of uint8 [H, W] frames (or None if the
    dataset is unavailable)."""
    path = find_dataset(name)
    if path is None:
        return None
    seq = ImageSequence(path)
    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    return [seq[i] for i in range(n)]


def load_sequence_array(name: str, max_frames: int | None = None):
    """Dataset name -> uint8 [T, H, W] array through the threaded native
    loader (or None if the dataset is unavailable)."""
    from .. import native

    path = find_dataset(name)
    if path is None:
        return None
    seq = ImageSequence(path)
    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    return native.load_pgm_batch(seq.paths(n), seq.nrows, seq.ncols)


DATASET_URLS = {
    # reference: src/V2/download_dataset.py:7-10
    "images_laptops": ("https://huggingface.co/datasets/FatimaSohailll/"
                       "PPM-Image-Dataset-for-KLT-Feature-Tracking/resolve/"
                       "main/images_laptops.zip"),
    "images_traffic": ("https://huggingface.co/datasets/FatimaSohailll/"
                       "PPM-Image-Dataset-for-KLT-Feature-Tracking/resolve/"
                       "main/images_traffic.zip"),
}


def download_dataset(name: str, dest_root: str = "data",
                     timeout: float = 60.0) -> str:
    """Fetch and unzip a benchmark sequence (the analogue of
    src/V2/download_dataset.py) into dest_root/name; returns that
    directory at once when it already exists.  Requires network access;
    raises RuntimeError with a clear message in offline environments."""
    import io
    import urllib.request
    import zipfile

    if name not in DATASET_URLS:
        raise KeyError(f"unknown dataset '{name}'; "
                       f"have {sorted(DATASET_URLS)}")
    dest = os.path.join(dest_root, name)
    if os.path.isdir(dest):
        return dest
    os.makedirs(dest_root, exist_ok=True)
    try:
        with urllib.request.urlopen(DATASET_URLS[name],
                                    timeout=timeout) as r:
            blob = r.read()
    except Exception as e:  # offline / blocked egress
        raise RuntimeError(
            f"could not download '{name}' ({e}); place the unzipped "
            f"sequence at {dest} or set KLT_DATA_ROOT") from e
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        z.extractall(dest_root)
    return dest
