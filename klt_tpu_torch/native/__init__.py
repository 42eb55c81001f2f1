"""ctypes bindings for the native host runtime (sort + suppression, the
threaded PGM batch loader), for the lazy sort that the suppression drives,
and for the scalar oracle of the bit-exact LK tier.

Compiles the port's own `kltnative.c`, beside this file (a byte-for-byte
copy of the JAX package's native source, which the tests hold equal),
with `cc -O2 -shared -fPIC` into the port's build directory on first use,
and again whenever the source is newer than the library; `lazy_select.c`
(`LazySort`, which includes `kltnative.c`'s helpers, and `candidate_list`,
the pass that writes the list it sorts; `LazySort.resume` takes up a sort
that kernel S began on the card) builds the same way into a library of
its own.  `lk_exact_ref.c`
(the scalar lane program of csrc/lk_exact_lane.h, whose per-cell helpers
kernel G shares, one feature after another) builds the same way with `cc -O0 -ffp-contract=off`, so that
every f32 operation rounds on its own, as the reference's goldens were
made (tools/fixtures/gen.sh).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build import BUILD_DIR, compile_shared, is_stale, repo_path

_SRC = repo_path("klt_tpu_torch", "native", "kltnative.c")
_LIB = os.path.join(BUILD_DIR, "libkltnative.so")
_REF_SRC = repo_path("klt_tpu_torch", "native", "lk_exact_ref.c")
_REF_DEPS = [_REF_SRC, repo_path("klt_tpu_torch", "csrc", "lk_exact_lane.h")]
_REF_LIB = os.path.join(BUILD_DIR, "liblkexactref.so")
_LAZY_SRC = repo_path("klt_tpu_torch", "native", "lazy_select.c")
_LAZY_LIB = os.path.join(BUILD_DIR, "liblazyselect.so")
_lock = threading.Lock()
_lib = None
_ref_lib = None
_lazy_lib = None
# The most ranges a LazySort keeps pending; a range that would nest
# deeper is sorted whole (lazy_select.c).  Its state stays this small, so
# each call allocates no buffer that grows with the candidate list.
LAZY_PENDING = 128


def _open(lib: str, deps: list[str], flags: list[str]) -> ctypes.CDLL:
    """The library `lib`, compiled from deps[0] first when any of deps is
    newer than it."""
    if is_stale(lib, deps):
        cc = os.environ.get("CC", "cc")
        compile_shared([cc, *flags, "-shared", "-fPIC", deps[0]], lib)
    return ctypes.CDLL(lib)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _open(_LIB, [_SRC], ["-O2", "-pthread"])
        lib.klt_sort_points_desc.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.klt_sort_points_desc.restype = None
        lib.klt_min_dist_suppress.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32]
        lib.klt_min_dist_suppress.restype = None
        lib.klt_load_pgm_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64]
        lib.klt_load_pgm_batch.restype = ctypes.c_int64
        _lib = lib
        return lib


def sort_points_desc(pts: np.ndarray) -> np.ndarray:
    """In-place descending sort of int32 [n, 3] (x, y, val) triples by val,
    with the reference's exact tie ordering."""
    pts = np.ascontiguousarray(pts, dtype=np.int32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected [n, 3] points, got {pts.shape}")
    lib = _load()
    lib.klt_sort_points_desc(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(pts.shape[0]))
    return pts


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _check_points(pts: np.ndarray) -> None:
    if pts.dtype != np.int32 or not pts.flags.c_contiguous or \
            pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError("expected contiguous int32 [n, 3] points")


def _check_map(walk_map: np.ndarray) -> None:
    if walk_map.dtype != np.uint8 or walk_map.ndim != 2 or \
            not walk_map.flags.c_contiguous or not walk_map.flags.writeable:
        raise ValueError("walk_map must be a writeable contiguous uint8 "
                         "[nrows, ncols] map")


def _check_walk(pts: np.ndarray, fx: np.ndarray, fy: np.ndarray,
                fval: np.ndarray, ncols: int, nrows: int) -> None:
    """The suppression's arguments as its C loop reads them."""
    for a, dt in ((fx, np.float32), (fy, np.float32), (fval, np.int32)):
        if a.dtype != dt or not a.flags.c_contiguous or a.shape != fx.shape:
            raise ValueError("feature arrays must be contiguous [n] "
                             "float32 x, y and int32 val")
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected [n, 3] points, got {pts.shape}")
    if pts.size and (pts[:, 0].min() < 0 or pts[:, 0].max() >= ncols or
                     pts[:, 1].min() < 0 or pts[:, 1].max() >= nrows):
        raise ValueError("candidate points outside the image")


def min_dist_suppress(pts: np.ndarray, fx: np.ndarray, fy: np.ndarray,
                      fval: np.ndarray, ncols: int, nrows: int,
                      mindist: int, min_eigenvalue: int,
                      overwrite_all: bool) -> None:
    """Greedy minimum-distance acceptance into (fx, fy, fval), in place."""
    pts = np.ascontiguousarray(pts, dtype=np.int32)
    _check_walk(pts, fx, fy, fval, ncols, nrows)
    lib = _load()
    lib.klt_min_dist_suppress(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(pts.shape[0]),
        fx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fval.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(fx.shape[0]),
        ctypes.c_int32(ncols), ctypes.c_int32(nrows),
        ctypes.c_int32(max(mindist, 0)), ctypes.c_int32(min_eigenvalue),
        ctypes.c_int32(1 if overwrite_all else 0))


def _load_lazy() -> ctypes.CDLL:
    global _lazy_lib
    with _lock:
        if _lazy_lib is not None:
            return _lazy_lib
        lib = _open(_LAZY_LIB, [_LAZY_SRC, _SRC], ["-O2", "-pthread"])
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.klt_lazy_sort_begin.argtypes = [i32p, ctypes.c_int64, i64p]
        lib.klt_lazy_sort_begin.restype = None
        lib.klt_candidate_list.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p]
        lib.klt_candidate_list.restype = ctypes.c_int64
        lib.klt_partition_desc.argtypes = [i32p, ctypes.c_int64]
        lib.klt_partition_desc.restype = ctypes.c_int64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        walk = [f32p, f32p, i32p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32]
        lib.klt_lazy_walk_begin.argtypes = [u8p, i64p] + walk + \
            [ctypes.c_int32]
        lib.klt_lazy_walk_begin.restype = None
        lib.klt_lazy_walk.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                      i64p, u8p, i64p] + walk + \
            [ctypes.c_int32, ctypes.c_int32]
        lib.klt_lazy_walk.restype = ctypes.c_int32
        _lazy_lib = lib
        return lib


def partition_desc(pts: np.ndarray) -> int:
    """One partition of klt_sort_points_desc on the whole of `pts`
    (contiguous int32 [n, 3]), in place: the middle row's value as the
    pivot, Hoare's loop, the same swaps.  Returns the pivot's final row (0
    when n < 2)."""
    _check_points(pts)
    return int(_load_lazy().klt_partition_desc(
        _i32(pts), ctypes.c_int64(pts.shape[0])))


def candidate_count(ncols: int, nrows: int, borderx: int, bordery: int,
                    step: int) -> int:
    """The rows of `candidate_list`'s list: its grid's size."""
    if step < 1 or min(ncols, nrows, borderx, bordery) < 0:
        raise ValueError("step must be >= 1, sizes and borders >= 0")
    return len(range(bordery, nrows - bordery, step)) * \
        len(range(borderx, ncols - borderx, step))


def candidate_list(response: np.ndarray, ncols: int, nrows: int,
                   borderx: int, bordery: int, step: int,
                   out: np.ndarray) -> np.ndarray:
    """The reference's candidate rows (x, y, (int)response[y, x]),
    row-major over the grid of `step` inside the borders, written into
    `out` (lazy_select.c::klt_candidate_list).

    response: C-contiguous float32 [>= nrows, >= ncols]; out: C-contiguous
    int32 [candidate_count(...), 3], every row of which is written.
    Returns out."""
    n = candidate_count(ncols, nrows, borderx, bordery, step)
    if response.dtype != np.float32 or response.ndim != 2 or \
            not response.flags.c_contiguous or \
            response.shape[0] < nrows or response.shape[1] < ncols:
        raise ValueError(f"expected a contiguous float32 map of at least "
                         f"{nrows} x {ncols}")
    if out.dtype != np.int32 or out.shape != (n, 3) or \
            not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError(f"expected a writeable contiguous int32 [{n}, 3] "
                         f"list, got {out.dtype} {out.shape}")
    _load_lazy().klt_candidate_list(
        response.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(response.shape[1]), ctypes.c_int32(ncols),
        ctypes.c_int32(nrows), ctypes.c_int32(borderx),
        ctypes.c_int32(bordery), ctypes.c_int32(step),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


class LazySort:
    """`sort_points_desc` then `min_dist_suppress`, with only the rows the
    suppression reads sorted (lazy_select.c): the same features, and the
    same first `n_final` rows as the full sort, ties in the same order.

    pts: contiguous int32 [n, 3] (x, y, val) triples, partitioned in
    place.  Making the object partitions the list until row 0 holds the
    best candidate; `min_dist_suppress` sorts the rest of what it reads as
    it walks.  `resume` takes up a sort whose first partitions were made
    elsewhere (kernel S, on the card).  walk_map: a writeable contiguous
    uint8 [nrows, ncols] map of the image, the walk's, which the caller
    owns and may reuse from call to call."""

    def __init__(self, pts: np.ndarray, walk_map: np.ndarray):
        _check_points(pts)
        _check_map(walk_map)
        self.pts = pts
        self._rows = pts.shape[0]
        self._map = walk_map
        self._state = np.empty(3 + 2 * LAZY_PENDING, np.int64)
        self._state[0] = LAZY_PENDING
        _load_lazy().klt_lazy_sort_begin(
            _i32(pts), ctypes.c_int64(pts.shape[0]), _i64(self._state))

    @classmethod
    def resume(cls, pts: np.ndarray, state: np.ndarray, rows: int,
               walk_map: np.ndarray) -> "LazySort":
        """The lazy sort of the n triples of `pts` from `state`, an int64
        [3 + 2 * cap] state in lazy_select.c's layout that partitions of
        this list left, of which only rows [0, rows) have arrived in `pts`
        so far."""
        _check_points(pts)
        _check_map(walk_map)
        state = np.array(state, np.int64)
        cap = int(state[0])
        if state.shape != (3 + 2 * max(cap, 1),) or not \
                0 <= state[1] <= cap or not 0 <= rows <= pts.shape[0]:
            raise ValueError("state is not a lazy sort's state of this list")
        self = cls.__new__(cls)
        self.pts = pts
        self._rows = rows
        self._map = walk_map
        self._state = state
        return self

    @property
    def n_final(self) -> int:
        """The rows at the head of `pts` that hold their sorted values."""
        return int(self._state[2])

    def _avail(self) -> int:
        """The rows the walk may read: those that have arrived, up to the
        first pending range that reaches past them."""
        k = int(self._state[1])
        ranges = self._state[3:3 + 2 * k].reshape(k, 2)
        cut = ranges[(ranges[:, 0] < self._rows) &
                     (ranges[:, 1] > self._rows)]
        return int(cut[0, 0]) if len(cut) else self._rows

    def min_dist_suppress(self, fx: np.ndarray, fy: np.ndarray,
                          fval: np.ndarray, ncols: int, nrows: int,
                          mindist: int, min_eigenvalue: int,
                          overwrite_all: bool, more=None) -> None:
        """As the module's `min_dist_suppress` on the sorted list.  After
        `resume`, `more()` is called whenever the walk needs a row that has
        not arrived: it brings the rest of the list into `pts` and returns
        the rows that `pts` now holds."""
        pts = self.pts
        lib = _load_lazy()
        _check_walk(pts[:self._rows], fx, fy, fval, ncols, nrows)
        if self._map.shape != (nrows, ncols):
            raise ValueError(f"walk_map is {self._map.shape}, the image "
                             f"{nrows} x {ncols}")
        args = (_f32(fx), _f32(fy), _i32(fval), ctypes.c_int64(fx.shape[0]),
                ctypes.c_int32(ncols), ctypes.c_int32(nrows),
                ctypes.c_int32(max(mindist, 0)))
        overwrite = ctypes.c_int32(1 if overwrite_all else 0)
        at = np.zeros(2, np.int64)
        walk_map = self._map.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        lib.klt_lazy_walk_begin(walk_map, _i64(at), *args, overwrite)
        while lib.klt_lazy_walk(_i32(pts), ctypes.c_int64(pts.shape[0]),
                                ctypes.c_int64(self._avail()),
                                _i64(self._state), walk_map, _i64(at),
                                *args, ctypes.c_int32(min_eigenvalue),
                                overwrite):
            had = self._rows
            self._rows = more() if more is not None else had
            if not had < self._rows <= pts.shape[0]:
                raise RuntimeError(f"the walk needs row {int(at[0])} of "
                                   f"{pts.shape[0]}; {had} have arrived")
            _check_walk(pts[had:self._rows], fx, fy, fval, ncols, nrows)


def load_pgm_batch(paths, height: int, width: int,
                   n_threads: int = 8) -> np.ndarray:
    """Threaded batch load of binary PGM frames -> uint8 [n, h, w].

    The native analogue of looping pgmReadFile (src/V1/pnmio.c:206-230),
    parallelized across files for long sequences.  Every file must be
    height x width; raises OSError naming the first file that fails."""
    n = len(paths)
    if height <= 0 or width <= 0:
        raise ValueError("height and width must be positive")
    out = np.empty((n, height, width), np.uint8)
    if n == 0:
        return out
    names = [os.fsencode(p) for p in paths]
    arr = (ctypes.c_char_p * n)(*names)
    rc = _load().klt_load_pgm_batch(
        arr, ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(height), ctypes.c_int64(width),
        ctypes.c_int64(n_threads))
    if rc != 0:
        raise OSError(f"failed to load PGM file: {paths[rc - 1]}")
    return out


def _load_ref() -> ctypes.CDLL:
    global _ref_lib
    with _lock:
        if _ref_lib is not None:
            return _ref_lib
        lib = _open(_REF_LIB, _REF_DEPS, ["-O0", "-ffp-contract=off"])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.klt_exact_track_ref.argtypes = (
            [ctypes.POINTER(p), ctypes.POINTER(p), ctypes.POINTER(i),
             ctypes.POINTER(i), i, p, p, p, i, i, i, i] + [f] * 9 + [p] * 3)
        lib.klt_exact_track_ref.restype = i
        _ref_lib = lib
        return lib


def track_exact_ref(stacks1, stacks2, x, y, val, consts: dict):
    """The scalar lane program of csrc/lk_exact_lane.h on the host, one
    feature after another (kernel G spreads each lane over a warp).

    stacks1, stacks2: finest-first f32 [3, H_l, W_l] numpy stacks of the
    two frames; x, y f32 [N], val i32 [N]; consts: the lane program's
    configuration (`ops.lk_exact.exact_constants`).  Returns new numpy
    (x, y, val)."""
    st1 = [np.ascontiguousarray(s, np.float32) for s in stacks1]
    st2 = [np.ascontiguousarray(s, np.float32) for s in stacks2]
    if len(st1) != len(st2) or any(a.shape != b.shape or a.ndim != 3 or
                                   a.shape[0] != 3
                                   for a, b in zip(st1, st2)):
        raise ValueError("stacks must be pairs of equal [3, H, W] levels")
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    val = np.ascontiguousarray(val, np.int32)
    n = x.shape[0]
    if y.shape != (n,) or val.shape != (n,):
        raise ValueError("x, y, val must be [N]")
    nlev = len(st1)
    xo, yo, vo = np.empty_like(x), np.empty_like(y), np.empty_like(val)
    ptrs = ctypes.c_void_p * nlev
    ints = ctypes.c_int * nlev
    k = consts
    rc = _load_ref().klt_exact_track_ref(
        ptrs(*[a.ctypes.data for a in st1]),
        ptrs(*[a.ctypes.data for a in st2]),
        ints(*[a.shape[1] for a in st1]), ints(*[a.shape[2] for a in st1]),
        nlev, x.ctypes.data, y.ctypes.data, val.ctypes.data, n, k["win"],
        k["max_iterations"], k["check_residue"], k["subsampling"],
        k["min_determinant"], k["min_displacement"], k["step_factor"],
        k["max_residue"], k["border_x0"], k["border_x1"], k["border_y0"],
        k["border_y1"], xo.ctypes.data, yo.ctypes.data, vo.ctypes.data)
    if rc != 0:
        raise ValueError(f"the oracle takes 1 to 8 levels, got {nlev}")
    return xo, yo, vo
