"""Dense feature containers.

The reference's pointer-based FeatureList / FeatureHistory / FeatureTable
(src/V1/klt.h:92-122, src/V1/klt.c:143-236) become NumPy
structure-of-arrays so they move to and from device memory as whole
tensors.  Affine-consistency per-feature state (reference aff_* fields,
src/V1/klt.h:96-105) lives in dense [N, ...] arrays with a validity mask
instead of NULL pointers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import NOT_FOUND


@dataclasses.dataclass
class FeatureList:
    """Per-feature tracking state for one frame: x, y, val.

    val >= 0 means tracked (selection stores the corner response there);
    negative values are the loss codes from config (TRACKED..LARGE_RESIDUE).
    """

    x: np.ndarray
    y: np.ndarray
    val: np.ndarray

    @classmethod
    def create(cls, n_features: int) -> "FeatureList":
        return cls(x=np.full(n_features, -1.0, np.float32),
                   y=np.full(n_features, -1.0, np.float32),
                   val=np.full(n_features, NOT_FOUND, np.int32))

    @property
    def n_features(self) -> int:
        return int(self.x.shape[0])

    def count_remaining(self) -> int:
        """reference: KLTCountRemainingFeatures, src/V1/klt.c:507-518."""
        return int(np.sum(self.val >= 0))

    def copy(self) -> "FeatureList":
        return FeatureList(self.x.copy(), self.y.copy(), self.val.copy())


@dataclasses.dataclass
class FeatureHistory:
    """One feature's track across frames (src/V1/klt.h:113-116)."""

    x: np.ndarray
    y: np.ndarray
    val: np.ndarray

    @classmethod
    def create(cls, n_frames: int) -> "FeatureHistory":
        return cls(x=np.zeros(n_frames, np.float32),
                   y=np.zeros(n_frames, np.float32),
                   val=np.zeros(n_frames, np.int32))

    @property
    def n_frames(self) -> int:
        return int(self.x.shape[0])


@dataclasses.dataclass
class FeatureTable:
    """All features across all frames: [n_features, n_frames] arrays
    (src/V1/klt.h:118-122)."""

    x: np.ndarray
    y: np.ndarray
    val: np.ndarray

    @classmethod
    def create(cls, n_frames: int, n_features: int) -> "FeatureTable":
        return cls(x=np.zeros((n_features, n_frames), np.float32),
                   y=np.zeros((n_features, n_frames), np.float32),
                   val=np.zeros((n_features, n_frames), np.int32))

    @property
    def n_features(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_frames(self) -> int:
        return int(self.x.shape[1])

    # reference: storeFeatures.c:15-117
    def store_list(self, fl: FeatureList, frame: int) -> None:
        if not 0 <= frame < self.n_frames:
            raise IndexError(f"frame {frame} out of range")
        if fl.n_features != self.n_features:
            raise ValueError("feature count mismatch")
        self.x[:, frame] = fl.x
        self.y[:, frame] = fl.y
        self.val[:, frame] = fl.val

    def extract_list(self, frame: int) -> FeatureList:
        if not 0 <= frame < self.n_frames:
            raise IndexError(f"frame {frame} out of range")
        return FeatureList(self.x[:, frame].copy(), self.y[:, frame].copy(),
                           self.val[:, frame].copy())

    def store_history(self, fh: FeatureHistory, feat: int) -> None:
        if not 0 <= feat < self.n_features:
            raise IndexError(f"feature {feat} out of range")
        self.x[feat, :] = fh.x
        self.y[feat, :] = fh.y
        self.val[feat, :] = fh.val

    def extract_history(self, feat: int) -> FeatureHistory:
        if not 0 <= feat < self.n_features:
            raise IndexError(f"feature {feat} out of range")
        return FeatureHistory(self.x[feat, :].copy(), self.y[feat, :].copy(),
                              self.val[feat, :].copy())
