"""Build and load the port's host (CPU) libraries.

The sources are `hifidiff_tpu_torch/csrc/host/*.cc`: the JPEG codec
(`jpeg.cc`) and the data-path core (`native.cc`, the port's copy of the JAX
package's `native/src/hifidiff_native.cc`). They are compiled with g++ (no
CUDA) at first use, into one shared library with a plain C interface under
`hifidiff_tpu_torch/_build/` (listed in .gitignore), with the flags of the
JAX package's `native/build.sh`, so the data-path core computes what the
JAX build computes on the same host. The library's name carries a hash of
the sources and flags, so an edited source is rebuilt; each process builds
into a file of its own and renames it into place, so processes that build
at once do not clash. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
SOURCES = ("jpeg.cc", "native.cc")
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread")


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host codec and data-path core "
                           "are built from hifidiff_tpu_torch/csrc/host at "
                           "first use")
    return found


def _build(path: pathlib.Path) -> str:
    tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.tmp"
    cmd = [_gxx(), *FLAGS, "-o", str(tmp), *(str(HOST_SRC / s)
                                             for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, path)
    return f"{' '.join(cmd)}\n{res.stderr}".strip()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed. Its `build_log`
    attribute holds the g++ command and its output, or "cached" when an
    earlier build was reused."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update((HOST_SRC / name).read_bytes())
    path = BUILD_DIR / f"libhifidiff_host_{h.hexdigest()[:16]}.so"
    log = "cached"
    if not path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        log = _build(path)
    lib = ctypes.CDLL(str(path))
    p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip, szp, cp = (ctypes.POINTER(i), ctypes.POINTER(sz), ctypes.c_char_p)
    lib.hj_decode.argtypes = [p, sz, ip, ip, cp, i]
    lib.hj_decode.restype = p
    lib.hj_encode.argtypes = [p, i, i, i, szp, cp, i]
    lib.hj_encode.restype = p
    lib.hj_free.argtypes = [p]
    lib.hj_free.restype = None
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.hn_resize.argtypes = [f32p, f32p] + [i] * 6
    lib.hn_filter2d.argtypes = [f32p, f32p, i, i, i, f32p, i, i]
    lib.hn_add_gaussian_noise.argtypes = [f32p, ctypes.c_int64,
                                          ctypes.c_float, ctypes.c_uint64]
    lib.hn_quantize8.argtypes = [f32p, ctypes.c_int64]
    lib.hn_degrade_stage1.argtypes = [f32p, f32p, i, i, i, f32p, i, i, i,
                                      ctypes.c_float, ctypes.c_uint64]
    lib.hn_resize_batch.argtypes = [f32p, f32p] + [i] * 8
    for name in ("hn_resize", "hn_filter2d", "hn_add_gaussian_noise",
                 "hn_quantize8", "hn_degrade_stage1", "hn_resize_batch"):
        getattr(lib, name).restype = None
    lib.build_log = log
    return lib
