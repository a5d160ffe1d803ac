"""Build and load the port's host (CPU) library.

The sources are `hifidiff_tpu_torch/csrc/host/*.cc`: the JPEG codec
(`jpeg.cc`), the data-path core (`native.cc`, the port's copy of the JAX
package's `native/src/hifidiff_native.cc`), the image path (`image.cc`:
the PNG row filters and passes, the BMP layouts and RLE, cv2's and PIL's
resizes, cv2's filter2D) and the WebP decoder (`webp.cc`). g++ (no
CUDA) compiles each into an object of its own with its own flags, all at
once, at first use, and links them into one shared library with a plain C
interface under `hifidiff_tpu_torch/_build/` (listed in .gitignore); it
links nothing beyond libstdc++.

`native.cc` and `jpeg.cc` take the flags of the JAX package's
`native/build.sh`, so the data-path core computes what the JAX build
computes on the same host. `image.cc` adds `-ffp-contract=off`: with
`-march=native` g++ would otherwise fuse `a*b + c` into one rounding, and
the image path's sums, held bit for bit to their numpy versions, would
differ from numpy's in the last bit. `webp.cc` computes in integers only
and takes the flag all the same.

The library's name carries a hash of the sources and flags, so an edited
source is rebuilt; each process builds into files of its own and renames
the library into place, so processes that build at once do not clash, and
within a process one thread builds and loads it while the others (a
`Loader`'s threads, say) wait for it. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
SOURCES = ("jpeg.cc", "native.cc", "image.cc", "webp.cc")
# native/build.sh's flags, for every object and the link
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread")
# what a source adds to them
EXTRA_FLAGS = {"image.cc": ("-ffp-contract=off",),
               "webp.cc": ("-ffp-contract=off",)}

# what every hi_* function of image.cc and hw_* function of webp.cc
# returns where an allocation failed
NO_MEMORY = 99


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host codec, data-path core "
                           "and image path are built from "
                           "hifidiff_tpu_torch/csrc/host at first use")
    return found


def _run(cmds):
    """Runs the commands at once; raises with the first failure's output.
    Returns each command's line, output and seconds."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], None
    for cmd, p in zip(cmds, procs):
        out = p.communicate()[0]
        logs.append(f"{' '.join(cmd)}  [{time.perf_counter() - t0:.2f} s]"
                    + (f"\n{out.strip()}" if out.strip() else ""))
        if p.returncode != 0 and failed is None:
            failed = (p.returncode, cmd, out)
    if failed is not None:
        code, cmd, out = failed
        raise RuntimeError(f"g++ failed with code {code}:\n{' '.join(cmd)}\n"
                           f"{out}")
    return logs


def _build(path: pathlib.Path) -> str:
    gxx = _gxx()
    tag = f"{path.stem}.{os.getpid()}"
    objs = {name: BUILD_DIR / f"{tag}.{pathlib.Path(name).stem}.o"
            for name in SOURCES}
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        logs = _run([[gxx, *FLAGS, *EXTRA_FLAGS.get(name, ()), "-c", "-o",
                      str(objs[name]), str(HOST_SRC / name)]
                     for name in SOURCES])
        logs += _run([[gxx, *FLAGS, "-o", str(tmp),
                       *map(str, objs.values())]])
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs.values():
            o.unlink(missing_ok=True)
    return "\n".join(logs)


_LOADING = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed. Its `build_log`
    attribute holds each g++ command with the seconds since the build
    started and its output, or "cached" when an earlier build was reused.
    `ctypes.CDLL` releases the GIL for every call."""
    with _LOADING:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update(" ".join((name,) + EXTRA_FLAGS.get(name, ())).encode())
        h.update((HOST_SRC / name).read_bytes())
    path = BUILD_DIR / f"libhifidiff_host_{h.hexdigest()[:16]}.so"
    log = "cached"
    if not path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        log = _build(path)
    lib = ctypes.CDLL(str(path))
    p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip, szp, cp = (ctypes.POINTER(i), ctypes.POINTER(sz), ctypes.c_char_p)
    lib.hj_decode.argtypes = [p, sz, i, ip, ip, cp, i]
    lib.hj_decode.restype = p
    lib.hj_components.argtypes = [p, sz, ip, ip, ip, ip, cp, i]
    lib.hj_components.restype = p
    lib.hj_ycck_cmyk.argtypes = [p, sz, p]
    lib.hj_cmyk_rgb.argtypes = [p, sz, i, p]
    lib.hj_ycck_cmyk.restype = lib.hj_cmyk_rgb.restype = None
    lib.hj_encode.argtypes = [p, i, i, i, szp, cp, i]
    lib.hj_encode.restype = p
    lib.hj_coefficients.argtypes = [p, sz, szp, cp, i]
    lib.hj_coefficients.restype = p
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
    # the image path (image.cc): every buffer a raw address
    lib.hi_png_rgb.argtypes = [p, sz, i, i, i, i, p, i, i, i, p, ip]
    lib.hi_bmp_rgb.argtypes = [p, sz, sz] + [i] * 8 + [p, i, i, p, ip]
    lib.hi_resize_cv2_f32.argtypes = [p, p] + [i] * 6
    lib.hi_resize_cv2_u8_cubic.argtypes = [p, p] + [i] * 5
    lib.hi_resize_pil.argtypes = [p, p] + [i] * 6
    lib.hi_filter2d.argtypes = [p, p, i, i, i, p, i, i]
    for name in ("hi_png_rgb", "hi_bmp_rgb", "hi_resize_cv2_f32",
                 "hi_resize_cv2_u8_cubic", "hi_resize_pil", "hi_filter2d"):
        getattr(lib, name).restype = i   # 0, a refusal, or NO_MEMORY
    # the WebP decoder (webp.cc)
    lib.hw_webp_rgb.argtypes = [p, sz, i, i, i, p, sz, i, i, i, i, p, ip]
    lib.hw_alpha.argtypes = [p, sz, i, i, p, ip]
    lib.hw_vp8_coefficients.argtypes = [p, sz, p, p, ip]
    for name in ("hw_webp_rgb", "hw_alpha", "hw_vp8_coefficients"):
        getattr(lib, name).restype = i
    lib.build_log = log
    return lib
