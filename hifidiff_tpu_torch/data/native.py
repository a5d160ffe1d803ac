"""The data-path core in C++ (counterpart of hifidiff_tpu/data/native.py):
`csrc/host/native.cc`, the port's copy of the JAX package's
`native/src/hifidiff_native.cc`, built with its flags by `data/host.py`.

cv2-semantics resize (INTER_LINEAR / INTER_CUBIC), BORDER_REFLECT_101
`filter2d`, Xorshift128+ Box-Muller Gaussian noise, 8-bit quantization, the
fused blur -> downsample -> noise stage of the blind branch, and a threaded
batch resize, all on float32 HWC arrays. There is no availability gate:
the library is built at first use, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from hifidiff_tpu_torch.data import host


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f32c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def resize(img: np.ndarray, out_hw, cubic: bool = True) -> np.ndarray:
    img = _f32c(img)
    h, w, c = img.shape
    oh, ow = out_hw
    out = np.empty((oh, ow, c), np.float32)
    host.library().hn_resize(_ptr(img), _ptr(out), h, w, c, oh, ow,
                             int(cubic))
    return out


def resize_batch(imgs: np.ndarray, out_hw, cubic: bool = True,
                 num_threads: int = 0) -> np.ndarray:
    imgs = _f32c(imgs)
    b, h, w, c = imgs.shape
    oh, ow = out_hw
    out = np.empty((b, oh, ow, c), np.float32)
    threads = num_threads or (os.cpu_count() or 1)
    host.library().hn_resize_batch(_ptr(imgs), _ptr(out), b, h, w, c, oh,
                                   ow, int(cubic), threads)
    return out


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    img = _f32c(img)
    kernel = _f32c(kernel)
    h, w, c = img.shape
    out = np.empty_like(img)
    host.library().hn_filter2d(_ptr(img), _ptr(out), h, w, c, _ptr(kernel),
                               kernel.shape[0], kernel.shape[1])
    return out


def add_gaussian_noise(img: np.ndarray, sigma: float,
                       seed: int) -> np.ndarray:
    img = _f32c(img).copy()
    host.library().hn_add_gaussian_noise(_ptr(img), img.size, sigma, seed)
    return img


def quantize8(img: np.ndarray) -> np.ndarray:
    img = _f32c(img).copy()
    host.library().hn_quantize8(_ptr(img), img.size)
    return img


def degrade_stage1(img: np.ndarray, kernel: np.ndarray, small_hw,
                   noise_sigma: float, seed: int) -> np.ndarray:
    """Fused blur -> bilinear downsample -> clipped Gaussian noise."""
    img = _f32c(img)
    kernel = _f32c(kernel)
    h, w, c = img.shape
    sh, sw = small_hw
    out = np.empty((sh, sw, c), np.float32)
    host.library().hn_degrade_stage1(_ptr(img), _ptr(out), h, w, c,
                                     _ptr(kernel), kernel.shape[0], sh, sw,
                                     noise_sigma, seed)
    return out
