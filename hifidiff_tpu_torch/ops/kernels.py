"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in `hifidiff_tpu_torch/csrc/*.cu`. They are compiled with
nvcc for `sm_90a` into one shared library with a plain C interface and bound
with ctypes; no PyTorch header is included, so the build takes seconds. The
build runs at the first launch, from the package's own sources, into
`hifidiff_tpu_torch/_build/` (listed in .gitignore): one nvcc per source, all
started together, then one link. The library's name carries a hash of the
sources and flags, so an edited source is rebuilt.

`LAUNCHES` counts launches per kernel. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path went
through the kernels; the plain versions (CPU tensors) do not count.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("ln_film.cu", "ln_film_bwd.cu", "warp.cu", "warp_bwd.cu",
            "matmul_w8.cu", "gn_silu.cu", "cnaf_small.cu")
_HEADERS = ("common.cuh", "gemm_tile.cuh", "ln_tile.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"ln_film": 0, "ln_film_bwd": 0, "affine_warp": 0,
            "affine_warp_bwd": 0, "matmul_w8": 0, "group_norm_silu": 0,
            "cnaf_small": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            "hifidiff_tpu_torch/csrc at first use and need the CUDA toolkit")
    return found


def _build(path: pathlib.Path) -> str:
    """Compile every source to an object file, all nvcc processes started
    together, link them into `path`, and return nvcc's stderr (ptxas -v)."""
    nvcc, tag = _nvcc(), f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s}.o" for s in _SOURCES]
    cmds = [[nvcc, *_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(_SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    results = [(c, p.communicate()[1], p.returncode)
               for c, p in zip(cmds, procs)]
    try:
        tmp = BUILD_DIR / f"{tag}.tmp"
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(code == 0 for _, _, code in results):
            res = subprocess.run(link, capture_output=True, text=True)
            results.append((link, res.stderr, res.returncode))
        for cmd, err, code in results:
            if code != 0:
                raise RuntimeError(f"nvcc failed with code {code}:\n"
                                   f"{' '.join(cmd)}\n{err}")
        os.replace(tmp, path)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(err for _, err, _ in results)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed. Its `build_log`
    attribute holds nvcc's report (registers, shared memory, spills), or
    "cached" when an earlier build was reused."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in (*_HEADERS, *_SOURCES):
        h.update((CSRC / name).read_bytes())
    path = BUILD_DIR / f"libhifidiff_kernels_{h.hexdigest()[:16]}.so"
    log = "cached"
    if not path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        log = _build(path)
    lib = ctypes.CDLL(str(path))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.hifidiff_ln_film.argtypes = [p, p, p, p, p, p, i, i, i, ll, f, i, p]
    lib.hifidiff_ln_film.restype = i
    lib.hifidiff_ln_film_bwd.argtypes = [*([p] * 11), i, i, i, ll, i, f, i,
                                         i, p]
    lib.hifidiff_ln_film_bwd.restype = i
    lib.hifidiff_ln_film_bwd_scratch.argtypes = [i, i, i, i, i, i]
    lib.hifidiff_ln_film_bwd_scratch.restype = ll
    lib.hifidiff_affine_warp.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.hifidiff_affine_warp.restype = i
    lib.hifidiff_affine_warp_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                             i, i, p]
    lib.hifidiff_affine_warp_bwd.restype = i
    lib.hifidiff_affine_warp_bwd_scratch.argtypes = [i, i, i, i]
    lib.hifidiff_affine_warp_bwd_scratch.restype = ll
    lib.hifidiff_matmul_w8.argtypes = [p, p, p, p, i, i, i, p]
    lib.hifidiff_matmul_w8.restype = i
    lib.hifidiff_matmul_w8_plan.argtypes = [i, i, i, ctypes.POINTER(i * 4)]
    lib.hifidiff_matmul_w8_plan.restype = None
    lib.hifidiff_gn_silu.argtypes = [p, p, p, p, i, i, i, i, f, i, p]
    lib.hifidiff_gn_silu.restype = i
    lib.hifidiff_gn_silu_plan.argtypes = [i, i, i, i, ctypes.POINTER(i * 6)]
    lib.hifidiff_gn_silu_plan.restype = None
    lib.hifidiff_cnaf_small.argtypes = [*([p] * 13), i, i, i, i, f, p]
    lib.hifidiff_cnaf_small.restype = i
    lib.build_log = log
    return lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")


def check_same_device(name: str, *tensors: torch.Tensor) -> None:
    """What every kernel wrapper requires of a CUDA call: all tensors on one
    CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")


def on_cpu(name: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version's turn), False for a CUDA
    tensor (the kernel's); any other device is refused."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cpu"


def wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_launchable(name: str, *tensors: torch.Tensor) -> None:
    """The requirements of an inference-only kernel (`matmul_w8`,
    `group_norm_silu(fused=True)`, the fused small-map block): all tensors on
    one CUDA device, and no gradient wanted. `ln_film` and the warp have
    backward kernels and go through `torch.autograd.Function`s instead."""
    check_same_device(name, *tensors)
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (inference only); call "
            "it under torch.inference_mode() or torch.no_grad()")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor, name: str) -> int:
    """1 for bf16, 0 for f32; anything else is refused."""
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"{name}: dtype {t.dtype} not supported "
                    "(float32 or bfloat16)")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The vector loads of the kernels need 16-byte aligned base pointers
    (every tensor PyTorch allocates is; a view at an odd offset is not)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not 16-byte aligned")
