"""Degradations of the training data (counterpart of
hifidiff_tpu/data/degradations.py; host-side numpy, no cv2).

Each function takes the same `np.random.Generator` draws, in the same order,
as the JAX package's, so that a loader seeded alike draws the same
degradations. The images are float32 [0, 1] HWC in RGB order: every op is
channelwise but `to_gray3`, which weighs the channels as cv2's
`COLOR_BGR2GRAY` weighs the BGR image the JAX package holds.

`filter2d` is cv2's `filter2D(img, -1, kernel)`: a correlation with the
anchor at the kernel's centre and `BORDER_REFLECT_101` borders, one call to
the host library (`csrc/host/image.cc`, built by `data/host.py`), made
without the GIL; `filter2d_plain` is its numpy version, bit for bit equal
to it, called only by tests and chip_smoke.py.

The JPEG round trip runs the port's codec (`data/jpeg.py`), which writes
the bytes `cv2.imencode` writes and reads back what `cv2.imdecode` reads;
the RGB image goes in as RGB, as cv2 takes the JAX package's BGR, so both
see the same YCbCr. `blind_degrade` takes the JAX package's cv2 path by
default (`filter2d`, `resize_cv2` linear, float64 normals; the blur and
the resizes in the host library's `image.cc`) and its native
path (`data/native.py`: the fused C++ stage, Xorshift128+ noise from one
drawn seed) when asked with `native=True`; the two draw differently, as in
the JAX package, where the native path is taken whenever its library is
built.
"""

from __future__ import annotations

import math

import numpy as np

from hifidiff_tpu_torch.data import host
from hifidiff_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
from hifidiff_tpu_torch.data.resize import bgr2gray, resize_cv2


def bivariate_gaussian_kernel(kernel_size: int, sigma_x: float,
                              sigma_y: float, theta: float) -> np.ndarray:
    """Rotated anisotropic Gaussian kernel, normalized to sum 1."""
    half = kernel_size // 2
    xs, ys = np.meshgrid(np.arange(-half, half + 1),
                         np.arange(-half, half + 1))
    coords = np.stack([xs, ys], axis=-1).astype(np.float64)  # (k, k, 2)
    c, s = math.cos(theta), math.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    sigma = rot @ np.diag([sigma_x ** 2, sigma_y ** 2]) @ rot.T
    inv = np.linalg.inv(sigma)
    z = np.einsum("hwi,ij,hwj->hw", coords, inv, coords)
    kernel = np.exp(-0.5 * z)
    return (kernel / kernel.sum()).astype(np.float32)


def random_mixed_kernel(rng: np.random.Generator, kernel_size: int,
                        sigma_x_range=(0.1, 1.0), sigma_y_range=(0.1, 1.0),
                        rotation_range=(-math.pi, math.pi),
                        iso_prob: float = 0.5) -> np.ndarray:
    """iso/aniso mixture, the reference's `random_mixed_kernels` with
    ["iso", "aniso"] at [0.5, 0.5] (`dataset_multipie.py:107-115`)."""
    sigma_x = rng.uniform(*sigma_x_range)
    if rng.uniform() < iso_prob:
        return bivariate_gaussian_kernel(kernel_size, sigma_x, sigma_x, 0.0)
    sigma_y = rng.uniform(*sigma_y_range)
    theta = rng.uniform(*rotation_range)
    return bivariate_gaussian_kernel(kernel_size, sigma_x, sigma_y, theta)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2's `filter2D(img, -1, kernel)` on a float32 (H, W) or (H, W, C)
    image: correlation with `kernel` (kh, kw), anchor at the centre,
    `BORDER_REFLECT_101` borders (as `np.pad(mode="reflect")` gives them,
    reflected again where the image is smaller than the kernel), each
    value summed in float64 over the kernel in row-major order and returned
    as float32."""
    if img.dtype != np.float32 or img.ndim not in (2, 3) \
            or min(img.shape[:2]) < 1:
        raise ValueError(f"filter2d takes a float32 (H, W) or (H, W, C) "
                         f"image, got {img.shape} {img.dtype}")
    kernel = np.ascontiguousarray(kernel, np.float64)
    kh, kw = kernel.shape
    if not kernel.size:
        raise ValueError(f"filter2d takes a non-empty kernel, got {kh}x{kw}")
    src = np.ascontiguousarray(img)
    out = np.empty(img.shape, np.float32)
    if host.library().hi_filter2d(src.ctypes.data, out.ctypes.data,
                                  img.shape[0], img.shape[1],
                                  img.shape[2] if img.ndim == 3 else 1,
                                  kernel.ctypes.data, kh, kw):
        raise MemoryError("filter2d: out of memory")
    return out


def filter2d_plain(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """`filter2d` in numpy: its plain version."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    pad = [(ay, kh - 1 - ay), (ax, kw - 1 - ax)] + [(0, 0)] * (img.ndim - 2)
    src = np.pad(img.astype(np.float64), pad, mode="reflect")
    h, w = img.shape[:2]
    out = np.zeros(img.shape, np.float64)
    for i in range(kh):
        for j in range(kw):
            out += float(kernel[i, j]) * src[i:i + h, j:j + w]
    return out.astype(np.float32)


def add_gaussian_noise(rng: np.random.Generator, img: np.ndarray,
                       sigma_range=(0.0, 5.0)) -> np.ndarray:
    """img float32 [0,1]; sigma drawn in 8-bit units (basicsr convention)."""
    sigma = rng.uniform(*sigma_range) / 255.0
    noise = rng.standard_normal(img.shape, dtype=np.float32) * sigma
    return np.clip(img + noise, 0.0, 1.0)


def jpeg_roundtrip(rng: np.random.Generator, img: np.ndarray,
                   quality_range=(80, 100)) -> np.ndarray:
    """Encode/decode through JPEG at a random quality (80-99 by default:
    `int` truncates the uniform draw); img float32 [0,1] RGB, truncated to
    uint8 before encoding, as the JAX package does."""
    q = int(rng.uniform(*quality_range))
    enc = encode_jpeg((img * 255.0).clip(0, 255).astype(np.uint8), q)
    return decode_jpeg(enc).astype(np.float32) / 255.0


def color_jitter_pair(rng: np.random.Generator, a: np.ndarray, b: np.ndarray,
                      shift: float = 0.05):
    """Joint per-channel shift applied to both images
    (`dataset_multipie.py:26-34`). The three shifts are drawn in the JAX
    package's (BGR) channel order and applied to the RGB channels they
    belong to."""
    jitter = rng.uniform(-shift, shift, 3).astype(np.float32)[::-1]
    return (np.clip(a + jitter, 0, 1), np.clip(b + jitter, 0, 1))


def to_gray3(img: np.ndarray) -> np.ndarray:
    """Grey repeated over three channels, with cv2's `COLOR_BGR2GRAY`
    weights on the BGR form of the RGB `img`."""
    return np.repeat(bgr2gray(img)[:, :, None], 3, axis=2)


def blind_degrade(rng: np.random.Generator, img: np.ndarray,
                  size: int = 128, native: bool = False) -> np.ndarray:
    """The full blind branch on a float32 [0,1] RGB image: blur ->
    downsample U(1,8) -> noise -> JPEG -> resize back
    (`dataset_multipie.py:104-146`; jitter and grey are the caller's).

    `native=False` is the JAX package's cv2 path; `native=True` its native
    path. Either draws what the JAX package's draws from `rng`, and the
    noise lands on the channel it lands on in the JAX package's BGR image
    (the native stage runs on the BGR form)."""
    ksize = int(rng.integers(4, 6)) * 2 + 1  # 9 or 11
    kernel = random_mixed_kernel(rng, ksize)
    scale = rng.uniform(1.0, 8.0)
    small = int(128 // scale)
    sigma = rng.uniform(0.0, 5.0) / 255.0

    if native:
        from hifidiff_tpu_torch.data import native as hn

        bgr = np.ascontiguousarray(img[..., ::-1])
        img = hn.degrade_stage1(bgr, kernel, (small, small), sigma,
                                int(rng.integers(0, 2 ** 62)))[..., ::-1]
        img = jpeg_roundtrip(rng, np.ascontiguousarray(img))
        return hn.resize(img, (size, size), cubic=False)

    img = filter2d(img, kernel)
    img = resize_cv2(img, (small, small), "linear")
    noise = rng.standard_normal(img.shape).astype(np.float32)[..., ::-1]
    img = np.clip(img + noise * sigma, 0.0, 1.0)
    img = jpeg_roundtrip(rng, img)
    return resize_cv2(img, (size, size), "linear")


def quantize_8bit(img: np.ndarray) -> np.ndarray:
    """Snap to the 8-bit grid (`dataset_multipie.py:160-166`)."""
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.float32) / 255.0
