"""Build the CUDA sources under csrc/ into one shared library and load it.

`load()` runs nvcc at first use (the sources include no PyTorch header and
export a plain C interface; about 40 s on an 8-core host, most of it the
unrolled AIRs of composition.cu) into `build/`, next to this
package and listed in .gitignore: one nvcc a source, all started together,
then one link.  The library's file name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a stale one is never loaded.
nvcc's stderr, which holds ptxas' register and spill report, is kept beside
the library as `<name>.log`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libposeidon2_m31_{h.hexdigest()[:16]}.so")


def ptxas_report(name: str) -> list:
    """ptxas' report of every compiled kernel whose mangled name holds
    `name` (one a template instance), read from the library's log:
    [{"kernel", "registers", "smem_bytes", "stack_bytes", "spill_stores",
    "spill_loads"}] (smem_bytes: the static shared memory; dynamic shared
    memory is set at launch)."""
    with open(library_path() + ".log") as f:
        log = f.read()
    entries = re.findall(r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads\n.*?Used (\d+) registers([^\n]*)", log)
    return [dict(kernel=k, registers=int(r), smem_bytes=int(next(iter(re.findall(r"(\d+) bytes smem", rest)), 0)),
                 stack_bytes=int(st), spill_stores=int(ss), spill_loads=int(sl))
            for k, st, ss, sl, r, rest in entries if name in k]


def sass_instructions(name: str) -> list:
    """The SASS instruction count of every compiled kernel whose mangled
    name holds `name`, from cuobjdump (beside nvcc) on the built library:
    [{"kernel", "instructions"}]."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", library_path()], capture_output=True, text=True, check=True).stdout
    counts, kernel = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            kernel = head.group(1)
            counts[kernel] = 0
        elif kernel is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[kernel] += 1
    return [dict(kernel=k, instructions=n) for k, n in counts.items() if name in k]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


def _compile(path: str) -> None:
    """One nvcc a source, all started together, then one link; the object
    files and the partial library are removed whether or not it succeeds."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(cu, objs)
    ]
    try:
        log = []
        failed = []
        for src, proc in zip(cu, procs):
            _, err = proc.communicate()
            log.append(f"== {os.path.basename(src)}\n{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src} ({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stderr}")
        with open(path + ".log", "w") as f:
            f.write("\n".join(log) + link.stderr)
        os.replace(tmp, path)
    finally:
        for leftover in objs + [tmp]:
            if os.path.exists(leftover):
                os.remove(leftover)


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            for name in ("p2_permute_rows_quad", "p2_permute_rows_tile"):
                getattr(lib, name).argtypes = [vp, vp, i64, vp]
                getattr(lib, name).restype = ctypes.c_int
            lib.p2_permute_wordmajor.argtypes = [vp, vp, i64, i64, vp]
            lib.p2_permute_wordmajor.restype = ctypes.c_int
            lib.p2_wordmajor_scan.argtypes = [vp, i64, i64, i64, ctypes.c_int, vp, vp]
            lib.p2_wordmajor_scan.restype = ctypes.c_int
            lib.sha256_level.argtypes = [vp, vp, i64, i64, i64, vp, vp]
            lib.sha256_level.restype = ctypes.c_int
            lib.sha256_grind.argtypes = [vp, ctypes.c_uint32, ctypes.c_uint64, vp, vp]
            lib.sha256_grind.restype = ctypes.c_int
            lib.p2_grind.argtypes = [vp, ctypes.c_uint32, ctypes.c_uint64, vp, vp]
            lib.p2_grind.restype = ctypes.c_int
            i64p, i32 = ctypes.POINTER(i64), ctypes.c_int
            lib.composition_check.argtypes = [i32, vp, i64, vp, vp, i64, i64, i64p, i64p, vp, vp, vp]
            lib.composition_check.restype = ctypes.c_int
            lib.composition_domain.argtypes = [i32, vp, vp, vp, vp, vp, vp, i32, i64, i64p, vp]
            lib.composition_domain.restype = ctypes.c_int
            lib.fold_phase.argtypes = [i64p, i64p, vp]
            lib.fold_phase.restype = ctypes.c_int
            lib.transcript_replay.argtypes = [i64p, i64p, vp]
            lib.transcript_replay.restype = ctypes.c_int
            lib.circle_fft.argtypes = [i64p, i64p, vp, i64p]
            lib.circle_fft.restype = ctypes.c_int
            lib.quotients_group.argtypes = [i64p, i64p, vp]
            lib.quotients_group.restype = ctypes.c_int
            lib.sample_columns.argtypes = [i64p, i64, i64p, i64, vp, i64, vp]
            lib.sample_columns.restype = ctypes.c_int
            lib.interaction_columns.argtypes = [i32, vp, i64, vp, i64, vp, i64, i64, i64p, vp]
            lib.interaction_columns.restype = ctypes.c_int
            lib.fri_fold_layer.argtypes = [vp, vp, vp, i64, vp, vp, i64, i64p, vp]
            lib.fri_fold_layer.restype = ctypes.c_int
            lib.fri_last_layer.argtypes = [vp, vp, vp, vp, i64, i64, i64, vp]
            lib.fri_last_layer.restype = ctypes.c_int
            lib.merkle_level.argtypes = [vp, vp, i64, i64, vp, i64, vp]
            lib.merkle_level.restype = ctypes.c_int
            lib.latency_probe.argtypes = [i32, i64, vp, vp, vp]
            lib.latency_probe.restype = ctypes.c_int
            _lib = lib
        return _lib
