"""Host-side image resizes with the semantics of the two libraries the JAX
package's data modules call: `cv2.resize` (INTER_CUBIC, INTER_LINEAR) and
PIL's `Image.resize` (BICUBIC, NEAREST), on HWC arrays. The port carries no
cv2 and no PIL; these are its counterparts.

`resize_cv2` and `resize_pil` run in the host library (`csrc/host/image.cc`,
built by `data/host.py`), one call each, which ctypes makes without the
GIL. `resize_cv2_plain` and `resize_pil_plain` are the same resizes in
numpy, their plain versions, bit for bit equal to them; only tests and
chip_smoke.py call those. What follows describes both.

`resize_cv2` (cv2's `resizeGeneric`):
  * the source coordinate of output pixel d is `(d + 0.5) * in/out - 0.5`,
    its floor the base tap; cubic takes taps -1..2 with A = -0.75, linear
    taps 0..1; taps are clamped to the border (replicate); no antialias on
    a downscale and no clamp of the output;
  * float32: the coefficients in float32 as cv2 computes them, a horizontal
    pass, then a vertical pass, each summing in float32 in the order cv2's
    code sums (cubic: bit-equal to cv2's own algorithm built for 4-lane
    vectors; linear: within an ulp or two);
  * uint8 (cubic only): cv2's fixed point, the coefficients rounded to
    11 bits, the horizontal pass in integers, the vertical pass as cv2's
    vector code does it (float32, rounded half to even, saturated).

cv2 hands some ratios (4/3, 6/5, ...) to IPP where it is built in; IPP's
results are not cv2's own algorithm's and differ from these by up to ~6e-6
(float32) or one level (uint8).

`resize_pil` (Pillow's `libImaging/Resample.c` and `Geometry.c`):
  * bicubic: a = -0.5, the support scaled by the factor on a downscale,
    each output pixel's coefficients normalised to sum 1 and turned into
    fixed point with 22 fraction bits; a horizontal pass, then a vertical
    pass, each rounding and clipping to uint8 (a pass whose size does not
    change is skipped);
  * nearest: the source index `floor(x0 + d * s)`, x0 = s / 2, the
    position accumulated in float64 as Pillow accumulates it.

`bgr2gray` is cv2's `COLOR_BGR2GRAY` on float32, written for RGB channel
order.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from hifidiff_tpu_torch.data import host

CV2_CUBIC_A = np.float32(-0.75)
INTER_RESIZE_COEF_BITS = 11
PIL_PRECISION_BITS = 32 - 8 - 2


def _cv2_taps(in_size: int, out_size: int, mode: str):
    """Per output index: the clamped source taps (out, k) and their float32
    coefficients (out, k), as cv2's resize computes them."""
    scale = 1.0 / (out_size / in_size)   # cv2: 1. / inv_scale (doubles)
    d = np.arange(out_size, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    base = np.floor(f).astype(np.int64)
    x = f - base.astype(np.float32)      # float32, as `fx -= sx`
    if mode == "cubic":
        a = CV2_CUBIC_A
        one = np.float32(1)
        x1 = x + one
        c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
        c1 = ((a + 2) * x - (a + 3)) * x * x + one
        y = one - x
        c2 = ((a + 2) * y - (a + 3)) * y * y + one
        c3 = one - c0 - c1 - c2
        coef = np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)
        offsets = np.arange(-1, 3)
    elif mode == "linear":
        # cv2 pins a coordinate outside [0, in-1] to the edge pixel
        low, high = base < 0, base >= in_size - 1
        x = np.where(low | high, np.float32(0), x)
        base = np.where(low, 0, np.where(high, in_size - 1, base))
        coef = np.stack([np.float32(1) - x, x], axis=1).astype(np.float32)
        offsets = np.arange(0, 2)
    else:
        raise ValueError(f"resize_cv2: mode must be 'cubic' or 'linear', "
                         f"got {mode!r}")
    taps = np.clip(base[:, None] + offsets[None, :], 0, in_size - 1)
    return taps, coef


def _sum_taps(img, taps, coef, axis):
    """sum_k coef[:, k] * img taken at taps[:, k] along `axis`, summed tap
    by tap in order, in float32."""
    shape = [1] * img.ndim
    shape[axis] = -1
    acc = None
    for k in range(taps.shape[1]):
        term = np.take(img, taps[:, k], axis=axis) * coef[:, k].reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def _check_hwc(img: np.ndarray, who: str) -> None:
    if img.ndim not in (2, 3):
        raise ValueError(f"{who} takes an (H, W) or (H, W, C) array, got "
                         f"shape {img.shape}")


def _call(fn, img: np.ndarray, h_out: int, w_out: int, *mode) -> np.ndarray:
    """`fn` of the host library from `img` into a new (h_out, w_out, ...)
    array of its dtype."""
    h, w = img.shape[:2]
    if min(h, w, h_out, w_out) < 1:
        raise ValueError(f"resize from {h}x{w} to {h_out}x{w_out}: every "
                         "side must be at least 1")
    src = np.ascontiguousarray(img)
    out = np.empty((h_out, w_out) + img.shape[2:], img.dtype)
    ch = img.shape[2] if img.ndim == 3 else 1
    code = fn(src.ctypes.data, out.ctypes.data, h, w, ch, h_out, w_out,
              *mode)
    if code == host.NO_MEMORY:
        raise MemoryError(f"{fn.__name__}: out of memory")
    if code:
        raise RuntimeError(f"{fn.__name__} returned {code}")
    return out


def resize_cv2(img: np.ndarray, size: Tuple[int, int],
               mode: str = "cubic") -> np.ndarray:
    """`cv2.resize(img, size, interpolation=INTER_CUBIC / INTER_LINEAR)`
    on an (H, W) or (H, W, C) float32 array (or uint8, cubic only), `size`
    given as cv2 takes it: (width, height)."""
    _check_hwc(img, "resize_cv2")
    w_out, h_out = int(size[0]), int(size[1])
    if img.shape[:2] == (h_out, w_out):
        return img.copy()
    lib = host.library()
    if img.dtype == np.uint8:
        if mode != "cubic":
            raise ValueError("resize_cv2 on uint8 is cubic only")
        return _call(lib.hi_resize_cv2_u8_cubic, img, h_out, w_out)
    if img.dtype != np.float32:
        raise ValueError(f"resize_cv2 takes float32 or uint8, got "
                         f"{img.dtype}")
    if mode not in ("cubic", "linear"):
        raise ValueError(f"resize_cv2: mode must be 'cubic' or 'linear', "
                         f"got {mode!r}")
    return _call(lib.hi_resize_cv2_f32, img, h_out, w_out,
                 0 if mode == "cubic" else 1)


def resize_cv2_plain(img: np.ndarray, size: Tuple[int, int],
                     mode: str = "cubic") -> np.ndarray:
    """`resize_cv2` in numpy: its plain version."""
    _check_hwc(img, "resize_cv2")
    w_out, h_out = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (h, w) == (h_out, w_out):
        return img.copy()
    if img.dtype == np.uint8:
        if mode != "cubic":
            raise ValueError("resize_cv2 on uint8 is cubic only")
        return _resize_cv2_u8_cubic(img, w_out, h_out)
    if img.dtype != np.float32:
        raise ValueError(f"resize_cv2 takes float32 or uint8, got "
                         f"{img.dtype}")
    taps_x, coef_x = _cv2_taps(w, w_out, mode)
    taps_y, coef_y = _cv2_taps(h, h_out, mode)
    rows = _sum_taps(img, taps_x, coef_x, axis=1)
    out = _sum_taps(rows, taps_y, coef_y, axis=0)
    if mode == "cubic":
        # cv2's vector loop (4 float lanes) sums the vertical taps from the
        # last, b0*S0 + (b1*S1 + (b2*S2 + b3*S3)); the scalar tail of each
        # output row sums them in order
        lanes = _sum_taps(rows, taps_y[:, ::-1], coef_y[:, ::-1], axis=0)
        flat, vec = out.reshape(h_out, -1), lanes.reshape(h_out, -1)
        cut = flat.shape[1] // 4 * 4
        flat[:, :cut] = vec[:, :cut]
    return out.astype(np.float32)


def _resize_cv2_u8_cubic(img, w_out, h_out):
    h, w = img.shape[:2]
    one = 1 << INTER_RESIZE_COEF_BITS
    taps_x, coef_x = _cv2_taps(w, w_out, "cubic")
    taps_y, coef_y = _cv2_taps(h, h_out, "cubic")
    # saturate_cast<short>(c * 2048): round half to even
    ix = np.rint(coef_x * np.float32(one)).astype(np.int64)
    iy = np.rint(coef_y * np.float32(one))
    rows = sum(np.take(img.astype(np.int64), taps_x[:, k], axis=1)
               * ix[:, k].reshape((1, -1) + (1,) * (img.ndim - 2))
               for k in range(4))
    # the vertical pass as cv2's vector code computes it: the integer rows
    # in float32 times beta / 2048**2, summed from the last tap, rounded
    # half to even and saturated
    beta = (iy * np.float32(1.0 / (one * one))).astype(np.float32)
    acc = None
    for k in (3, 2, 1, 0):
        term = (np.take(rows, taps_y[:, k], axis=0).astype(np.float32)
                * beta[:, k].reshape((-1,) + (1,) * (img.ndim - 1)))
        acc = term if acc is None else term + acc
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


# -- PIL ----------------------------------------------------------------------

def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _pil_coeffs(in_size: int, out_size: int):
    """Pillow's `precompute_coeffs` for the bicubic filter over the box
    (0, in_size) and `normalize_coeffs_8bpc`: per output pixel the first
    source pixel, the number of taps, and the (out, ksize) int64 fixed-point
    coefficients."""
    support = 2.0
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # (int)(v): truncation toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    j = np.arange(ksize)
    w = _pil_bicubic((j[None, :] + xmin[:, None] - center[:, None] + 0.5)
                     * ss)
    w = np.where(j[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):     # summed in order, as Pillow sums
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = w * float(1 << PIL_PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    return xmin, xmax, kk


def _pil_pass(img: np.ndarray, in_size: int, out_size: int,
              axis: int) -> np.ndarray:
    xmin, xmax, kk = _pil_coeffs(in_size, out_size)
    src = img.astype(np.int64)
    shape = [1] * img.ndim
    shape[axis] = -1
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PIL_PRECISION_BITS - 1), np.int64)
    for k in range(kk.shape[1]):
        idx = np.minimum(xmin + k, in_size - 1)   # taps past xmax weigh 0
        acc += np.take(src, idx, axis=axis) * kk[:, k].reshape(shape)
    return np.clip(acc >> PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def _pil_nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = in_size / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1,
                                                          step)]))
    return np.clip(pos.astype(np.int64), 0, in_size - 1)


def resize_pil(img: np.ndarray, size: Tuple[int, int],
               mode: str = "bicubic") -> np.ndarray:
    """`Image.fromarray(img).resize(size, BICUBIC / NEAREST)` on an (H, W)
    or (H, W, C) uint8 array, `size` given as PIL takes it: (width,
    height)."""
    _check_hwc(img, "resize_pil")
    if img.dtype != np.uint8:
        raise ValueError(f"resize_pil takes uint8, got {img.dtype}")
    if mode not in ("bicubic", "nearest"):
        raise ValueError(f"resize_pil: mode must be 'bicubic' or 'nearest', "
                         f"got {mode!r}")
    return _call(host.library().hi_resize_pil, img, int(size[1]),
                 int(size[0]), 0 if mode == "bicubic" else 1)


def resize_pil_plain(img: np.ndarray, size: Tuple[int, int],
                     mode: str = "bicubic") -> np.ndarray:
    """`resize_pil` in numpy: its plain version."""
    _check_hwc(img, "resize_pil")
    if img.dtype != np.uint8:
        raise ValueError(f"resize_pil takes uint8, got {img.dtype}")
    w_out, h_out = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if mode == "nearest":
        return img[_pil_nearest_index(h, h_out)][
            :, _pil_nearest_index(w, w_out)].copy()
    if mode != "bicubic":
        raise ValueError(f"resize_pil: mode must be 'bicubic' or 'nearest', "
                         f"got {mode!r}")
    out = img
    if w_out != w:
        out = _pil_pass(out, w, w_out, axis=1)
    if h_out != h:
        out = _pil_pass(out, h, h_out, axis=0)
    return out.copy() if out is img else out


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """cv2's `COLOR_BGR2GRAY` of the BGR image whose RGB form is `img`
    (float32, (H, W, 3)): B * 0.114 + G * 0.587 + R * 0.299 in float32, in
    cv2's order."""
    f = np.float32
    return (img[..., 2] * f(0.114) + img[..., 1] * f(0.587)
            + img[..., 0] * f(0.299)).astype(np.float32)
