"""ctypes loader for the native host kernels (native/poseidon31.cpp).

Builds the shared library on first use (g++, cached in the port's
git-ignored build/ directory); falls back silently to the pure-numpy
implementations when no compiler is available.  The device path never goes
through here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_SRC = os.path.join(
    os.path.dirname(__file__), "..", "..", "native", "poseidon31.cpp"
)
_PATH_SRC = os.path.join(os.path.dirname(_SRC), "pathexpand.cpp")
_SHA_SRC_ = os.path.join(os.path.dirname(_SRC), "sha256.cpp")
_BUILD = os.path.join(os.path.dirname(__file__), "..", "build")
_LIB = os.path.join(_BUILD, "libposeidon31.so")

_lock = threading.Lock()
_lib = None
_tried = False


def omp_threads() -> int:
    """The OpenMP threads of the native kernels: RSTPU_OMP_THREADS, else 1."""
    return int(os.environ.get("RSTPU_OMP_THREADS", "1"))


def _set_omp_threads():
    """Pin OpenMP to one thread unless overridden.

    Measured on this 2-vCPU host: a parallel-region wakeup costs ~8 ms
    (hypervisor scheduling of the second vCPU) and the second thread never
    wins even on 64k-permutation batches (16.4 ms vs 12.4 ms single).  The
    8 ms tax per native call was the dominant cost of host hint prep."""
    n = omp_threads()
    os.environ.setdefault("OMP_NUM_THREADS", str(n))
    try:
        ctypes.CDLL("libgomp.so.1").omp_set_num_threads(n)
    except Exception:
        pass


def _compile(lib_path: str, sources) -> None:
    """g++ `sources` into `lib_path`.  The library is written under a
    temporary name beside it and renamed into place, so processes that build
    at once (the lock below guards threads only) never load a partial file."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib_path))
    os.close(fd)
    try:
        subprocess.run(
            [
                "g++", "-O3", "-march=native", "-mno-sha", "-fopenmp",
                "-shared", "-fPIC", "-o", tmp, *sources,
            ],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            _set_omp_threads()
            if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < max(
                os.path.getmtime(_SRC), os.path.getmtime(_PATH_SRC),
                os.path.getmtime(_SHA_SRC_),
            ):
                _compile(_LIB, [_SRC, _PATH_SRC, _SHA_SRC_])
            lib = ctypes.CDLL(_LIB)
            lib.poseidon2_permute_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint64,
            ]
            lib.poseidon2_digest_chain.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.poseidon2_grind.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint32,
                ctypes.c_uint64,
            ]
            lib.poseidon2_grind.restype = ctypes.c_uint64
            lib.poseidon2_leaf_level.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.poseidon2_node_level.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
            ]
            _u32p_ = ctypes.POINTER(ctypes.c_uint32)
            _i64p_ = ctypes.POINTER(ctypes.c_int64)
            _u64p_ = ctypes.POINTER(ctypes.c_uint64)
            lib.rstpu_expand_single_paths.argtypes = [
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, _i64p_,
                _u32p_, _u64p_, _u32p_, _u64p_, _u32p_, _u32p_, _u32p_,
                _u32p_, ctypes.c_uint32,
            ]
            lib.rstpu_expand_single_paths.restype = ctypes.c_int
            lib.rstpu_expand_pair_paths.argtypes = [
                ctypes.c_uint32, ctypes.c_uint32, _u32p_, ctypes.c_uint32,
                ctypes.c_uint32, _i64p_, _u32p_, _u64p_, _u32p_, _u64p_,
                _u32p_, _u32p_, _u32p_, _u32p_, ctypes.c_uint32,
            ]
            lib.rstpu_expand_pair_paths.restype = ctypes.c_int
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def permute_batch(states: np.ndarray) -> np.ndarray:
    """In-place-free permutation of (..., 16) uint32 states via C++."""
    lib = _load()
    assert lib is not None
    out = np.ascontiguousarray(states, dtype=np.uint32).copy()
    flat = out.reshape(-1, 16)
    lib.poseidon2_permute_batch(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        flat.shape[0],
    )
    return out


def grind(digest: np.ndarray, bits: int, start: int = 0) -> int:
    lib = _load()
    assert lib is not None
    d = np.ascontiguousarray(digest, dtype=np.uint32)
    return int(
        lib.poseidon2_grind(
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), bits, start
        )
    )


# ---------------------------------------------------------------------------
# SHA-256 kernels (native/sha256.cpp): AVX-512 16-way vertical SIMD with a
# scalar fallback.  SHA-NI is deliberately disabled (-mno-sha): this image's
# hypervisor traps those instructions ~20x slower than plain scalar code.
# ---------------------------------------------------------------------------

_SHA_SRC = os.path.join(os.path.dirname(_SRC), "sha256.cpp")
_SHA_LIB = os.path.join(_BUILD, "libsha256.so")
_sha_lib = None
_sha_tried = False
_u32p = ctypes.POINTER(ctypes.c_uint32)


def _load_sha():
    global _sha_lib, _sha_tried
    with _lock:
        if _sha_tried:
            return _sha_lib
        _sha_tried = True
        try:
            if not os.path.exists(_SHA_LIB) or os.path.getmtime(
                _SHA_LIB
            ) < os.path.getmtime(_SHA_SRC):
                _compile(_SHA_LIB, [_SHA_SRC])
            lib = ctypes.CDLL(_SHA_LIB)
            lib.sha256_words_batch.argtypes = [
                _u32p, ctypes.c_uint64, ctypes.c_uint64, _u32p
            ]
            lib.sha256_leaf_level.argtypes = [
                _u32p, ctypes.c_uint64, ctypes.c_uint64, _u32p
            ]
            lib.sha256_node_level.argtypes = [
                _u32p, _u32p, ctypes.c_uint64, ctypes.c_uint64, _u32p
            ]
            lib.sha256_grind.argtypes = [_u32p, ctypes.c_uint32, ctypes.c_uint64]
            lib.sha256_grind.restype = ctypes.c_uint64
            _sha_lib = lib
        except Exception:
            _sha_lib = None
        return _sha_lib


def sha_available() -> bool:
    return _load_sha() is not None


def sha256_words_batch(words: np.ndarray) -> np.ndarray:
    """(N, K) uint32 BE words -> (N, 8) digests."""
    lib = _load_sha()
    assert lib is not None
    w = np.ascontiguousarray(words, np.uint32)
    n, k = w.shape
    out = np.empty((n, 8), np.uint32)
    lib.sha256_words_batch(
        w.ctypes.data_as(_u32p), n, k, out.ctypes.data_as(_u32p)
    )
    return out


def sha256_leaf_level(columns: np.ndarray) -> np.ndarray:
    """(n_cols, N) column-major leaves -> (N, 8) digests."""
    lib = _load_sha()
    assert lib is not None
    cols = np.ascontiguousarray(columns, np.uint32)
    n_cols, N = cols.shape
    out = np.empty((N, 8), np.uint32)
    lib.sha256_leaf_level(
        cols.ctypes.data_as(_u32p), n_cols, N, out.ctypes.data_as(_u32p)
    )
    return out


def sha256_node_level(
    children: np.ndarray, columns: np.ndarray | None
) -> np.ndarray:
    """children (2N, 8) + optional (n_cols, N) columns -> (N, 8)."""
    lib = _load_sha()
    assert lib is not None
    ch = np.ascontiguousarray(children, np.uint32)
    N = ch.shape[0] // 2
    out = np.empty((N, 8), np.uint32)
    if columns is not None and columns.shape[0]:
        cols = np.ascontiguousarray(columns, np.uint32)
        lib.sha256_node_level(
            ch.ctypes.data_as(_u32p), cols.ctypes.data_as(_u32p),
            cols.shape[0], N, out.ctypes.data_as(_u32p),
        )
    else:
        lib.sha256_node_level(
            ch.ctypes.data_as(_u32p), None, 0, N, out.ctypes.data_as(_u32p)
        )
    return out


def sha256_grind(digest_words: np.ndarray, bits: int, start: int = 0) -> int:
    lib = _load_sha()
    assert lib is not None
    d = np.ascontiguousarray(digest_words, np.uint32)
    return int(lib.sha256_grind(d.ctypes.data_as(_u32p), bits, start))


# ---------------------------------------------------------------------------
# M31 circle-FFT butterflies (native/m31fft.cpp) — host path for huge LDEs
# ---------------------------------------------------------------------------

_FFT_SRC = os.path.join(os.path.dirname(_SRC), "m31fft.cpp")
_FFT_LIB = os.path.join(_BUILD, "libm31fft.so")
_fft_lib = None
_fft_tried = False
_u64p = ctypes.POINTER(ctypes.c_uint64)


def _load_fft():
    global _fft_lib, _fft_tried
    with _lock:
        if _fft_tried:
            return _fft_lib
        _fft_tried = True
        try:
            if not os.path.exists(_FFT_LIB) or os.path.getmtime(
                _FFT_LIB
            ) < os.path.getmtime(_FFT_SRC):
                _compile(_FFT_LIB, [_FFT_SRC])
            lib = ctypes.CDLL(_FFT_LIB)
            lib.m31_fft_evaluate.argtypes = [
                _u32p, ctypes.c_uint64, ctypes.c_uint64, _u32p, _u64p,
                ctypes.c_uint32,
            ]
            lib.m31_fft_interpolate.argtypes = [
                _u32p, ctypes.c_uint64, ctypes.c_uint64, _u32p, _u64p,
                ctypes.c_uint32, ctypes.c_uint32,
            ]
            _fft_lib = lib
        except Exception:
            _fft_lib = None
        return _fft_lib


def fft_available() -> bool:
    return _load_fft() is not None


def _binop(fn_name: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load_fft()
    assert lib is not None
    fn = getattr(lib, fn_name)
    if not getattr(lib, "_" + fn_name + "_sig", False):
        fn.argtypes = [_u32p, _u32p, ctypes.c_uint64, _u32p]
        setattr(lib, "_" + fn_name + "_sig", True)
    fa = np.ascontiguousarray(a, np.uint32)
    fb = np.ascontiguousarray(b, np.uint32)
    out = np.empty(fa.shape, np.uint32)
    fn(
        fa.ctypes.data_as(_u32p), fb.ctypes.data_as(_u32p),
        fa.size, out.ctypes.data_as(_u32p),
    )
    return out


def m31_mul_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise (a*b) mod P for same-shape uint32 arrays."""
    return _binop("m31_mul_batch", a, b)


def m31_add_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _binop("m31_add_batch", a, b)


def m31_sub_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _binop("m31_sub_batch", a, b)


def m31_inv_batch(a: np.ndarray) -> np.ndarray:
    """Elementwise a^(p-2) mod P (bit-exact with core/m31.inv numpy)."""
    lib = _load_fft()
    assert lib is not None
    if not hasattr(lib, "_inv_sig"):
        lib.m31_inv_batch.argtypes = [_u32p, ctypes.c_uint64, _u32p]
        lib._inv_sig = True
    flat = np.ascontiguousarray(a, np.uint32)
    out = np.empty(flat.shape, np.uint32)
    lib.m31_inv_batch(
        flat.ctypes.data_as(_u32p), flat.size, out.ctypes.data_as(_u32p)
    )
    return out


def _twiddle_blob(tw_list):
    off = np.zeros(len(tw_list), np.uint64)
    pos = 0
    for i, t in enumerate(tw_list):
        off[i] = pos
        pos += len(t)
    blob = np.concatenate([np.asarray(t, np.uint32) for t in tw_list])
    return blob, off


def m31_fft_evaluate(coeffs: np.ndarray, tw_list) -> np.ndarray:
    """(rows, n) coefficients -> evaluations; bit-exact with
    circle_fft.evaluate."""
    lib = _load_fft()
    assert lib is not None
    v = np.ascontiguousarray(coeffs, np.uint32).copy()
    v2 = v.reshape(-1, v.shape[-1])
    blob, off = _twiddle_blob(tw_list)
    lib.m31_fft_evaluate(
        v2.ctypes.data_as(_u32p), v2.shape[0], v2.shape[1],
        blob.ctypes.data_as(_u32p), off.ctypes.data_as(_u64p),
        len(tw_list),
    )
    return v


def m31_fft_interpolate(values: np.ndarray, itw_list, inv2n: int) -> np.ndarray:
    lib = _load_fft()
    assert lib is not None
    v = np.ascontiguousarray(values, np.uint32).copy()
    v2 = v.reshape(-1, v.shape[-1])
    blob, off = _twiddle_blob(itw_list)
    lib.m31_fft_interpolate(
        v2.ctypes.data_as(_u32p), v2.shape[0], v2.shape[1],
        blob.ctypes.data_as(_u32p), off.ctypes.data_as(_u64p),
        len(itw_list), np.uint32(inv2n),
    )
    return v


def points_at_indices(idx: np.ndarray, gx: np.ndarray, gy: np.ndarray):
    """Vectorized circle point_at_index (native); idx uint64, gx/gy the 31
    generator-power coordinates."""
    lib = _load_fft()
    assert lib is not None
    if not hasattr(lib, "_points_sig"):
        lib.m31_points_at_indices.argtypes = [
            _u64p, ctypes.c_uint64, _u32p, _u32p, ctypes.c_uint32,
            _u32p, _u32p,
        ]
        lib._points_sig = True
    idx = np.ascontiguousarray(idx, np.uint64)
    gx = np.ascontiguousarray(gx, np.uint32)
    gy = np.ascontiguousarray(gy, np.uint32)
    out_x = np.empty(idx.shape, np.uint32)
    out_y = np.empty(idx.shape, np.uint32)
    lib.m31_points_at_indices(
        idx.ctypes.data_as(_u64p), idx.size,
        gx.ctypes.data_as(_u32p), gy.ctypes.data_as(_u32p), len(gx),
        out_x.ctypes.data_as(_u32p), out_y.ctypes.data_as(_u32p),
    )
    return out_x, out_y


def poseidon_leaf_level(columns: np.ndarray) -> np.ndarray:
    """(n_cols, N) -> (N, 8) Poseidon Merkle leaf digests (AVX-512)."""
    lib = _load()
    assert lib is not None
    cols = np.ascontiguousarray(columns, np.uint32)
    n_cols, N = cols.shape
    out = np.empty((N, 8), np.uint32)
    lib.poseidon2_leaf_level(
        cols.ctypes.data_as(_u32p), n_cols, N, out.ctypes.data_as(_u32p)
    )
    return out


def poseidon_node_level(
    children: np.ndarray, columns: np.ndarray | None
) -> np.ndarray:
    """children (2N, 8) + optional (n_cols, N) columns -> (N, 8)."""
    lib = _load()
    assert lib is not None
    ch = np.ascontiguousarray(children, np.uint32)
    N = ch.shape[0] // 2
    out = np.empty((N, 8), np.uint32)
    if columns is not None and columns.shape[0]:
        cols = np.ascontiguousarray(columns, np.uint32)
        lib.poseidon2_node_level(
            ch.ctypes.data_as(_u32p), cols.ctypes.data_as(_u32p),
            cols.shape[0], N, out.ctypes.data_as(_u32p),
        )
    else:
        lib.poseidon2_node_level(
            ch.ctypes.data_as(_u32p), None, 0, N, out.ctypes.data_as(_u32p)
        )
    return out


# ---------------------------------------------------------------------------
# Native path expansion (native/pathexpand.cpp) — the C++ twin of
# verifier/hints.py expand_single_paths_batched / expand_pair_paths_batched
# ---------------------------------------------------------------------------

_EXPAND_ERRORS = {
    -1: "value witness exhausted (corrupted proof?)",
    -2: "hash witness exhausted (corrupted proof?)",
    -3: "unconsumed witness",
    -4: "tree root mismatch",
}


def _concat_offsets(arrs, unit=1):
    off = np.zeros(len(arrs) + 1, np.uint64)
    pos = 0
    for i, a in enumerate(arrs):
        off[i] = pos
        pos += a.size // unit
    off[-1] = pos
    if pos:
        blob = np.ascontiguousarray(
            np.concatenate([a.ravel() for a in arrs]), np.uint32
        )
    else:
        blob = np.zeros(1, np.uint32)
    return blob, off


def expand_single_paths_batch(
    max_log: int,
    raw_queries: np.ndarray,
    values_list,
    n_columns_per_log_size: dict,
    hash_witness_list,
    roots: np.ndarray,
    flavor: str = "p31",
):
    """(sib (B, Q, max_log, 8), {log: (B, Q, ncols)}) via C++."""
    lib = _load()
    assert lib is not None
    B, Q = raw_queries.shape
    rq = np.ascontiguousarray(raw_queries, np.int64)
    vals, voff = _concat_offsets(
        [np.asarray(v, np.uint32) for v in values_list]
    )
    hws, hoff = _concat_offsets(
        [np.asarray(h, np.uint32) for h in hash_witness_list], unit=8
    )
    ncl = np.zeros(max_log + 1, np.uint32)
    for lvl, n in n_columns_per_log_size.items():
        ncl[lvl] = n
    roots_c = np.ascontiguousarray(roots, np.uint32)
    sib = np.empty((B, Q, max_log, 8), np.uint32)
    total_cols = int(sum(ncl)) * B * Q
    cols_buf = np.empty(max(total_cols, 1), np.uint32)
    rc = lib.rstpu_expand_single_paths(
        B, max_log, Q,
        rq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(_u32p),
        voff.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        hws.ctypes.data_as(_u32p),
        hoff.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ncl.ctypes.data_as(_u32p), roots_c.ctypes.data_as(_u32p),
        sib.ctypes.data_as(_u32p), cols_buf.ctypes.data_as(_u32p),
        1 if flavor == "sha256" else 0,
    )
    assert rc == 0, _EXPAND_ERRORS.get(rc, f"path expansion error {rc}")
    # slabs are laid out in descending log order by the kernel
    slab = {}
    pos = 0
    for lvl in range(max_log, -1, -1):
        if ncl[lvl]:
            n = int(ncl[lvl])
            slab[lvl] = cols_buf[pos : pos + B * Q * n].reshape(B, Q, n)
            pos += B * Q * n
    # dict INSERTION ORDER must replicate the numpy twin exactly (the
    # circuit layer allocates witness wires by iterating .items(); a
    # different order changes the trace): max_log first, then the
    # caller's n_columns_per_log_size order
    columns = {max_log: slab[max_log]}
    for lvl in n_columns_per_log_size:
        if lvl != max_log:
            columns[lvl] = slab.get(lvl, np.zeros((B, Q, 0), np.uint32))
    return sib, columns


def expand_pair_paths_batch(
    log_sizes_with_data,
    roots: np.ndarray,
    leaf_queries: np.ndarray,
    values_list,
    hash_witness_list,
    flavor: str = "p31",
):
    """(sib (B, Q, depth-1, 8), self {log: (B, Q, 4)}, sibling {log: ...})
    via C++."""
    lib = _load()
    assert lib is not None
    B, Q = leaf_queries.shape
    data_logs = np.asarray(list(log_sizes_with_data), np.uint32)
    max_log = int(data_logs.max())
    lq = np.ascontiguousarray(leaf_queries, np.int64)
    vals, voff = _concat_offsets(
        [np.asarray(v, np.uint32) for v in values_list]
    )
    hws, hoff = _concat_offsets(
        [np.asarray(h, np.uint32) for h in hash_witness_list], unit=8
    )
    roots_c = np.ascontiguousarray(roots, np.uint32)
    depth_out = max(max_log - 1, 0)
    sib = np.empty((B, Q, depth_out, 8), np.uint32)
    self_buf = np.empty((len(data_logs), B, Q, 4), np.uint32)
    sibc_buf = np.empty((len(data_logs), B, Q, 4), np.uint32)
    rc = lib.rstpu_expand_pair_paths(
        B, len(data_logs), data_logs.ctypes.data_as(_u32p), max_log, Q,
        lq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(_u32p),
        voff.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        hws.ctypes.data_as(_u32p),
        hoff.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        roots_c.ctypes.data_as(_u32p), sib.ctypes.data_as(_u32p),
        self_buf.ctypes.data_as(_u32p), sibc_buf.ctypes.data_as(_u32p),
        1 if flavor == "sha256" else 0,
    )
    assert rc == 0, _EXPAND_ERRORS.get(rc, f"path expansion error {rc}")
    # replicate the numpy twin's dict insertion order (set iteration —
    # the circuit layer's wire allocation order depends on it)
    slab_of = {int(lvl): i for i, lvl in enumerate(data_logs)}
    data_set = set(int(lvl) for lvl in log_sizes_with_data)
    self_cols = {lvl: self_buf[slab_of[lvl]] for lvl in data_set}
    sib_cols = {lvl: sibc_buf[slab_of[lvl]] for lvl in data_set}
    return sib, self_cols, sib_cols


def _fri_argtypes(lib):
    if getattr(lib, "_fri_sig", False):
        return
    u32 = ctypes.c_uint32
    lib.rstpu_fri_fold_hints.argtypes = [
        u32, u32, u32, u32, _u32p, u32,
        ctypes.POINTER(ctypes.c_int64),                      # raw_queries
        _u32p, _u32p, u32,                                   # answers, alphas
        _u32p, _u32p,                                        # yinv, xinv
        _u32p, ctypes.POINTER(ctypes.c_uint64),              # fl_wit
        _u32p, ctypes.POINTER(ctypes.c_uint64),              # fl_hw
        _u32p,                                               # fl_roots
        _u32p, ctypes.POINTER(ctypes.c_uint64),              # in_wit
        _u32p, ctypes.POINTER(ctypes.c_uint64),              # in_hw
        _u32p,                                               # in_roots
        _u32p, u32,                                          # ll_coeffs
        _u32p, u32,                                          # ll_xs
        _u32p, _u32p, _u32p, _u32p, _u32p, _u32p,            # outputs
    ]
    lib.rstpu_fri_fold_hints.restype = ctypes.c_int
    lib._fri_sig = True


_FRI_ERRORS = dict(_EXPAND_ERRORS)
_FRI_ERRORS[-5] = "fold state / first-layer pair mismatch"
_FRI_ERRORS[-6] = "last layer mismatch"


def fri_fold_hints(
    Q: int, M: int, group_logs, n_inner: int,
    raw_queries: np.ndarray,           # (B, Q) int64
    answers: np.ndarray,               # (n_groups, B, Q, 4)
    alphas: np.ndarray,                # (n_alpha, B, 4)
    yinv_fl: np.ndarray,               # (n_groups, B, Q)
    xinv_inner: np.ndarray,            # (n_inner, B, Q) (dummy if 0)
    fl_wit_list, fl_hw_list, fl_roots: np.ndarray,
    in_wit_lists, in_hw_lists, in_roots: np.ndarray,
    ll_coeffs: np.ndarray,             # (B, n_coeffs, 4)
    ll_xs: np.ndarray,                 # (n_doubles, B, Q)
    flavor: str = "p31",
):
    """Fused first-layer rebuild + folds + inner layers + pair expansion +
    last-layer check (native/pathexpand.cpp::rstpu_fri_fold_hints).

    Returns (fl_sib, fl_self, fl_sibc, [per-layer (sib, self, sibc)])."""
    lib = _load()
    assert lib is not None
    _fri_argtypes(lib)
    B = raw_queries.shape[0]
    n_groups = len(group_logs)
    gl = np.asarray(list(group_logs), np.uint32)
    raw = np.ascontiguousarray(raw_queries, np.int64)
    ans = np.ascontiguousarray(answers, np.uint32)
    alph = np.ascontiguousarray(alphas, np.uint32)
    yinv = np.ascontiguousarray(yinv_fl, np.uint32)
    xinv = np.ascontiguousarray(xinv_inner, np.uint32)
    fl_wit, fl_woff = _concat_offsets(
        [np.asarray(w, np.uint32) for w in fl_wit_list], unit=4
    )
    fl_hw, fl_hoff = _concat_offsets(
        [np.asarray(h, np.uint32) for h in fl_hw_list], unit=8
    )
    flr = np.ascontiguousarray(fl_roots, np.uint32)
    in_wit, in_woff = _concat_offsets(
        [np.asarray(w, np.uint32) for ws in in_wit_lists for w in ws],
        unit=4,
    )
    in_hw, in_hoff = _concat_offsets(
        [np.asarray(h, np.uint32) for hs in in_hw_lists for h in hs],
        unit=8,
    )
    inr = (
        np.ascontiguousarray(in_roots, np.uint32)
        if n_inner
        else np.zeros(1, np.uint32)
    )
    llc = np.ascontiguousarray(ll_coeffs, np.uint32)
    n_coeffs = llc.shape[1]
    llx = np.ascontiguousarray(ll_xs, np.uint32)
    n_doubles = n_coeffs.bit_length() - 1

    depth_fl = max(M - 1, 0)
    fl_sib = np.empty((B, Q, depth_fl, 8), np.uint32)
    fl_self = np.empty((n_groups, B, Q, 4), np.uint32)
    fl_sibc = np.empty((n_groups, B, Q, 4), np.uint32)
    in_depths = [max(M - 1 - i - 1, 0) for i in range(n_inner)]
    in_sib = np.empty((sum(in_depths) * B * Q * 8 or 1,), np.uint32)
    in_self = np.empty((max(n_inner, 1), B, Q, 4), np.uint32)
    in_sibc = np.empty((max(n_inner, 1), B, Q, 4), np.uint32)

    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.rstpu_fri_fold_hints(
        B, Q, M, n_groups, gl.ctypes.data_as(_u32p), n_inner,
        raw.ctypes.data_as(i64p),
        ans.ctypes.data_as(_u32p), alph.ctypes.data_as(_u32p),
        alph.shape[0],
        yinv.ctypes.data_as(_u32p), xinv.ctypes.data_as(_u32p),
        fl_wit.ctypes.data_as(_u32p), fl_woff.ctypes.data_as(u64p),
        fl_hw.ctypes.data_as(_u32p), fl_hoff.ctypes.data_as(u64p),
        flr.ctypes.data_as(_u32p),
        in_wit.ctypes.data_as(_u32p), in_woff.ctypes.data_as(u64p),
        in_hw.ctypes.data_as(_u32p), in_hoff.ctypes.data_as(u64p),
        inr.ctypes.data_as(_u32p),
        llc.ctypes.data_as(_u32p), n_coeffs,
        llx.ctypes.data_as(_u32p), n_doubles,
        fl_sib.ctypes.data_as(_u32p), fl_self.ctypes.data_as(_u32p),
        fl_sibc.ctypes.data_as(_u32p), in_sib.ctypes.data_as(_u32p),
        in_self.ctypes.data_as(_u32p), in_sibc.ctypes.data_as(_u32p),
        1 if flavor == "sha256" else 0,
    )
    assert rc == 0, _FRI_ERRORS.get(rc, f"fri hint error {rc}")
    inner = []
    pos = 0
    for i in range(n_inner):
        d = in_depths[i]
        sib = in_sib[pos : pos + B * Q * d * 8].reshape(B, Q, d, 8)
        pos += B * Q * d * 8
        inner.append((sib, in_self[i], in_sibc[i]))
    return fl_sib, fl_self, fl_sibc, inner


def _fri_answers_argtypes(lib):
    if getattr(lib, "_answers_sig", False):
        return
    u32 = ctypes.c_uint32
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.rstpu_fri_answers.argtypes = [
        u32, u32, u32, _u32p,            # B, Q, n_groups, group_ncols
        _u32p, u32,                      # samples_flat, S
        _u32p, u64p,                     # queried_rows, qr_off
        _u32p, _u32p,                    # dom_x, dom_y
        _u32p, u32,                      # rc, nb
        _u32p, _u32p, u64p,              # batch_group, batch_ncols, col_off
        _u32p, _u32p,                    # local_idx, sample_idx
        _u32p, _u32p, _u32p,             # batch_px, batch_py, out
    ]
    lib.rstpu_fri_answers.restype = ctypes.c_int
    lib._answers_sig = True


def fri_answers(
    Q: int,
    group_ncols,
    samples_flat: np.ndarray,      # (B, S, 4)
    queried_rows_slabs,            # per group (B, Q, C_g)
    dom_x: np.ndarray,             # (n_groups, B, Q)
    dom_y: np.ndarray,
    rc: np.ndarray,                # (B, 4)
    batch_group, batch_ncols, col_off, local_idx, sample_idx,
    batch_px: np.ndarray,          # (nb, B, 4)
    batch_py: np.ndarray,
) -> np.ndarray:
    """(n_groups, B, Q, 4) OODS quotients via C++
    (pathexpand.cpp::rstpu_fri_answers)."""
    lib = _load()
    assert lib is not None
    _fri_answers_argtypes(lib)
    B, S = samples_flat.shape[:2]
    n_groups = len(group_ncols)
    sf = np.ascontiguousarray(samples_flat, np.uint32)
    qr_off = np.zeros(n_groups + 1, np.uint64)
    pos = 0
    for g, slab in enumerate(queried_rows_slabs):
        qr_off[g] = pos
        pos += slab.size
    qr_off[-1] = pos
    qr = np.concatenate(
        [np.ascontiguousarray(s, np.uint32).ravel()
         for s in queried_rows_slabs]
    ) if pos else np.zeros(1, np.uint32)
    gx = np.ascontiguousarray(dom_x, np.uint32)
    gy = np.ascontiguousarray(dom_y, np.uint32)
    rcc = np.ascontiguousarray(rc, np.uint32)
    bg = np.asarray(batch_group, np.uint32)
    bn = np.asarray(batch_ncols, np.uint32)
    co = np.asarray(col_off, np.uint64)
    li = np.asarray(local_idx, np.uint32)
    si = np.asarray(sample_idx, np.uint32)
    px = np.ascontiguousarray(batch_px, np.uint32)
    py = np.ascontiguousarray(batch_py, np.uint32)
    out = np.empty((n_groups, B, Q, 4), np.uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    gnc = np.asarray(group_ncols, np.uint32)
    rcv = lib.rstpu_fri_answers(
        B, Q, n_groups, gnc.ctypes.data_as(_u32p),
        sf.ctypes.data_as(_u32p), S,
        qr.ctypes.data_as(_u32p), qr_off.ctypes.data_as(u64p),
        gx.ctypes.data_as(_u32p), gy.ctypes.data_as(_u32p),
        rcc.ctypes.data_as(_u32p), len(bg),
        bg.ctypes.data_as(_u32p), bn.ctypes.data_as(_u32p),
        co.ctypes.data_as(u64p), li.ctypes.data_as(_u32p),
        si.ctypes.data_as(_u32p), px.ctypes.data_as(_u32p),
        py.ctypes.data_as(_u32p), out.ctypes.data_as(_u32p),
    )
    assert rcv == 0
    return out
