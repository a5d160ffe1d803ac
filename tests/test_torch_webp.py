"""The port's WebP reader (`data/webp.py`, `csrc/host/webp.cc`) on the CPU,
held to PIL 12.1 and cv2 5.0 (both on libwebp 1.6), to its plain versions
and to the JAX package.

Tolerances: none. Every decode is bit-equal to PIL's `convert("RGB")` and
to cv2's `imdecode(..., IMREAD_COLOR)` flipped to RGB (they agree on every
still image and on every animation's first frame); `decode_webp_plain`
(the lossless decode in Python) to the library; `vp8_coefficients_plain`
(the lossy parse in Python) to the library's export; `decode_alpha` (an
ALPH chunk's alpha) to PIL's alpha and to `decode_alpha_plain`; a file
either library refuses is refused with a `WebPError` naming the cause,
the library and the plain versions with one message. The JAX datasets as
tests/test_torch_data.py holds them: every key of every item bit-equal,
cv2's IPP off for the classes that resize with cv2.

Animations, as both libraries' WebPAnimDecoder reads them (measured
here): the first frame drawn at its offset on a zero canvas, its pixels as
they are whatever its blend bit (libwebp blends no key frame; a blend onto
the zero canvas would move every opaque level down by one), the ANIM
background never drawn, the alpha dropped; every later frame checked by
the demuxer and never decoded. A broken ALPH chunk makes both refuse a
still image or a frame (cv2's WebPDecode decodes the alpha of any ALPH
chunk before the image, PIL's demuxer where the VP8X alpha flag is set).

`python tests/test_torch_webp.py` writes tests/fixtures/webp (PIL's files,
`data/image_files.vp8_frame`'s frames, the refused files) and its
digests.json again; `test_webp_fixtures_rebuilt` rebuilds every byte.
"""

import hashlib
import io
import json
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from hifidiff_tpu_torch.data import host, webp  # noqa: E402
from hifidiff_tpu_torch.data.image_files import (  # noqa: E402
    animated_webp, bmp_file, golden_input, png_file, vp8_frame,
    webp_frame_chunks)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "webp"


def _sha(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _cv2(data):
    out = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if out is None else np.ascontiguousarray(out[..., ::-1])


def _reads(fn, data):
    try:
        return fn(data)
    except Exception:   # what PIL and cv2 raise on a file they refuse
        return None


def _same(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape,
                                                               want.shape)
    assert got.tobytes() == want.tobytes(), int(np.abs(
        got.astype(int) - want.astype(int)).max())


def _save(img, **opts):
    out = io.BytesIO()
    Image.fromarray(img).save(out, "WEBP", **opts)
    return out.getvalue()


def _palette(seed, h, w, colors):
    """An (h, w, 3) image of exactly `colors` seeded colours, in runs."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (colors, 3), np.uint8)
    idx = rng.integers(0, colors, (h, w))
    idx[:, 1::2] = idx[:, ::2][:, :idx[:, 1::2].shape[1]]
    idx.reshape(-1)[:colors] = np.arange(colors)
    return pal[idx]


def _rgba(seed, h, w):
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 256, (h, w, 1), np.uint8)
    alpha[: h // 2] = 0                  # transparent pixels for `exact`
    return np.concatenate([golden_input(seed, h, w), alpha], -1)


def _face(size, seed=3):
    from hifidiff_tpu_torch.data import procedural as proc
    return (proc.render_face(proc._identity_params(0, seed), 0.2, size)
            * 255).astype(np.uint8)


def _textured(frame, seed):
    """`frame` with a seeded texture of about 20 levels, smooth over 4
    pixels: a lossy file of a photograph's size."""
    rng = np.random.default_rng(seed)
    tex = cv2.resize(rng.integers(-40, 41, (frame.shape[0] // 4,
                                            frame.shape[1] // 4, 3)).astype(
        np.float32), frame.shape[1::-1], interpolation=cv2.INTER_CUBIC)
    return np.clip(frame + 0.5 * tex, 0, 255).astype(np.uint8)


def _patch(data, at, new):
    return data[:at] + new + data[at + len(new):]


def _alpha_face(face):
    """The face with a soft round alpha: 0 in the corners, 255 inside it,
    every level between at its edge."""
    h, w = face.shape[:2]
    y, x = np.mgrid[:h, :w]
    r = np.hypot(y - h / 2 + 0.5, x - w / 2 + 0.5) / (min(h, w) / 2)
    alpha = np.clip((1.0 - r) * 8 * 255, 0, 255).astype(np.uint8)
    return np.concatenate([face, alpha[..., None]], -1)


def _animation(frames, **opts):
    """PIL's animated WebP of the (h, w, 3 or 4) uint8 `frames`."""
    out = io.BytesIO()
    first, *rest = (Image.fromarray(f) for f in frames)
    first.save(out, "WEBP", save_all=True, append_images=rest, **opts)
    return out.getvalue()


def _alph(data):
    """(offset, size) of the payload of a file's ALPH chunk."""
    at = data.index(b"ALPH")
    return at + 8, struct.unpack_from("<I", data, at + 4)[0]


def _with_alph(data, payload):
    """A still WebP file with its ALPH payload replaced by `payload`."""
    at, size = _alph(data)
    return _resize_riff(data[12:at - 8] + _chunk(b"ALPH", payload)
                        + data[at + size + (size & 1):])


def _filtered(alpha, method):
    """The inverse of dsp/filters.c's alpha unfilter `method` (1
    horizontal, 2 vertical, 3 gradient): the deltas an encoder writes."""
    a = alpha.astype(np.int64)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


def _resize_riff(body):
    return b"RIFF" + struct.pack("<I", len(body) + 4) + b"WEBP" + body


def _cut_lossless(data, keep):
    """A lossless file whose VP8L payload keeps `keep` bytes, its sizes
    made consistent: a bitstream that ends early."""
    payload = data[20:20 + keep]
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload
    return _resize_riff(chunk + b"\0" * (len(payload) & 1))


# -- fixtures -----------------------------------------------------------------

WRITER_FRAMES = {   # name: vp8_frame's keywords
    "vp8_parts2_simple_sharp3_45x37.webp":
        dict(seed=1, width=45, height=37, partitions=2, simple=True,
             sharpness=3, level=30),
    "vp8_parts4_deltas_segments_48x32.webp":
        dict(seed=2, width=48, height=32, partitions=4, segments=True,
             lf_deltas=(5, -3, 2, 0, -8, 4, 0, 1)),
    "vp8_parts8_sharp7_segments_33x70.webp":
        dict(seed=3, width=33, height=70, partitions=8, sharpness=7,
             segments=True, level=50),
    "vp8_simple_deltas_level63_17x9.webp":
        dict(seed=4, width=17, height=9, simple=True, level=63,
             lf_deltas=(-10, 0, 0, 0, 12, 0, 0, 0)),
}


def webp_fixtures():
    """{name: bytes}: PIL's lossy files (qualities 10-100, methods 0-6, odd
    sizes, 1 x 1, multiples of 16), lossless files (2, 4, 16, 256 and more
    colours, with alpha, exact or not), extended files (ALPH, ICCP, EXIF,
    XMP), the 160 x 160 face and a 1024 x 1024 frame in both (the lossy
    frame textured), the frames of `vp8_frame`, and the refused files."""
    g = golden_input
    face, frame = _face(160), _face(1024, seed=0)
    out = {
        "lossy_q10_m0_37x29.webp": _save(g(31, 29, 37), quality=10, method=0),
        "lossy_q30_m2_16x16.webp": _save(g(32, 16, 16), quality=30, method=2),
        "lossy_q50_m4_45x37.webp": _save(g(33, 37, 45), quality=50, method=4),
        "lossy_q75_m6_48x32.webp": _save(g(34, 32, 48), quality=75, method=6),
        "lossy_q90_m3_23x41.webp": _save(g(35, 41, 23), quality=90, method=3),
        "lossy_q100_m5_33x21.webp": _save(g(36, 21, 33), quality=100,
                                          method=5),
        "lossy_q80_m1_1x1.webp": _save(g(37, 1, 1), quality=80, method=1),
        "lossy_face_q90_160x160.webp": _save(face, quality=90),
        "lossy_frame_q80_1024x1024.webp": _save(_textured(frame, 5),
                                                quality=80),
        "lossless_2colors_33x21.webp": _save(_palette(41, 21, 33, 2),
                                             lossless=True),
        "lossless_4colors_37x29.webp": _save(_palette(42, 29, 37, 4),
                                             lossless=True),
        "lossless_16colors_45x37.webp": _save(_palette(43, 37, 45, 16),
                                              lossless=True),
        "lossless_256colors_48x40.webp": _save(_palette(44, 40, 48, 256),
                                               lossless=True),
        "lossless_rgb_m6_37x29.webp": _save(g(45, 29, 37), lossless=True,
                                            quality=100, method=6),
        "lossless_rgb_m0_23x31.webp": _save(g(46, 31, 23), lossless=True,
                                            quality=0, method=0),
        "lossless_alpha_exact_29x23.webp": _save(_rgba(47, 23, 29),
                                                 lossless=True, exact=True),
        "lossless_alpha_23x31.webp": _save(_rgba(48, 31, 23), lossless=True),
        "lossless_1x1.webp": _save(g(49, 1, 1), lossless=True),
        "lossless_face_160x160.webp": _save(face, lossless=True),
        "lossless_frame_1024x1024.webp": _save(frame, lossless=True),
        "vp8x_lossy_alph_iccp_exif_xmp_37x29.webp": _save(
            _rgba(51, 29, 37), quality=80, icc_profile=b"icc " * 9,
            exif=b"II*\0\x08\0\0\0\0\0\0\0\0\0", xmp=b"<x:xmpmeta/>"),
        "vp8x_lossless_alpha_exif_29x37.webp": _save(
            _rgba(52, 37, 29), lossless=True,
            exif=b"MM\0*\0\0\0\x08\0\0\0\0\0\0"),
    }
    for name, kw in WRITER_FRAMES.items():
        out[name] = vp8_frame(**kw)
    img = g(53, 19, 21)
    out["anim_lossless_21x19.webp"] = _animation([img, img[::-1]],
                                                 lossless=True)
    out.update(_animated_and_alpha_fixtures(face))
    out["refused_truncated_45x37.webp"] = out["lossy_q50_m4_45x37.webp"][:-40]
    canvas = out["vp8x_lossy_alph_iccp_exif_xmp_37x29.webp"]
    out["refused_canvas_37x29.webp"] = _patch(canvas, 24, (37).to_bytes(
        3, "little"))
    out["refused_lossless_ends_37x29.webp"] = _cut_lossless(
        out["lossless_rgb_m6_37x29.webp"], 300)
    alph = out["vp8x_alph_vertical_29x23.webp"]
    at, size = _alph(alph)
    out["refused_alph_stream_ends_29x23.webp"] = _with_alph(
        alph, alph[at:at + size - 40])
    out["refused_anim_frame_past_canvas_34x36.webp"] = animated_webp(
        34, 36, [(6, 10, 50, 0, webp_frame_chunks(
            _save(g(58, 23, 29), lossless=True)))])
    return out


def _animated_and_alpha_fixtures(face):
    """PIL's animations (lossless, and lossy with a soft alpha, of the 160
    x 160 face); animations of hand-placed frames (`animated_webp`): a
    lossy frame with partial alpha at an offset that is odd in the ANMF's
    halved units, blend bit clear, then a lossless frame; a lossless frame
    with alpha (RGB kept under alpha 0) that asks for no blending and
    disposal, on a canvas whose ANIM background is not black; and still
    files whose ALPH chunk is raw with the gradient filter, raw with the
    horizontal filter and the pre-processing bit, and compressed with the
    vertical filter."""
    g = golden_input
    alpha_face = _alpha_face(face)
    lossy = _save(_rgba(57, 23, 29), quality=70)
    alpha = np.asarray(Image.open(io.BytesIO(lossy)))[..., 3]
    at, size = _alph(lossy)
    return {
        "anim_lossless_face_160x160.webp": _animation(
            [face, np.roll(face, 9, 1)], lossless=True),
        "anim_lossy_alpha_face_160x160.webp": _animation(
            [alpha_face, alpha_face[:, ::-1]], quality=80),
        "anmf_lossy_alph_blend_40x36.webp": animated_webp(40, 36, [
            (6, 10, 50, 0, webp_frame_chunks(_save(_rgba(54, 23, 29),
                                                   quality=70))),
            (2, 2, 50, 2, webp_frame_chunks(_save(g(55, 23, 29),
                                                  lossless=True)))],
            background=0xFF102030),
        "anmf_lossless_alpha_noblend_dispose_40x36.webp": animated_webp(
            40, 36, [(10, 2, 80, 3, webp_frame_chunks(_save(
                _rgba(56, 29, 23), lossless=True, exact=True)))],
            background=0x80FFFFFF, loop=3),
        "vp8x_alph_raw_gradient_29x23.webp": _with_alph(
            lossy, b"\x0c" + _filtered(alpha, 3).tobytes()),
        "vp8x_alph_raw_horizontal_pre_29x23.webp": _with_alph(
            lossy, b"\x14" + _filtered(alpha, 1).tobytes()),
        "vp8x_alph_vertical_29x23.webp": _with_alph(
            lossy, bytes([lossy[at] & 0xF3 | 0x08]) + lossy[at + 1:at + size]),
    }


REFUSE = {
    "refused_alph_stream_ends_29x23.webp":
        "the ALPH chunk's stream: the lossless bitstream ends early",
    "refused_anim_frame_past_canvas_34x36.webp":
        r"a 29 x 23 frame at \(6, 10\) past the 34 x 36 canvas",
    "refused_truncated_45x37.webp": "truncated",
    "refused_canvas_37x29.webp": "a 37 x 29 image on a VP8X canvas of 38 x 29",
    "refused_lossless_ends_37x29.webp": "the lossless bitstream ends early",
}


def _pil_alpha(data):
    """PIL's alpha of the frame a file's ALPH chunk belongs to (its
    canvas's alpha where the first frame lies)."""
    f = webp.parse(data)
    rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    return rgba[f.y:f.y + f.height, f.x:f.x + f.width, 3]


def _digests(files):
    out = {"source": "PIL 12.1.0 and cv2 5.0.0 (libwebp 1.6.0): each file "
                     "decoded as the named library decodes it, RGB uint8; "
                     "'alpha': PIL's alpha of the frame whose ALPH chunk "
                     "the decoder reads",
           "decode": {}, "alpha": {}, "refuse": REFUSE}
    for name, data in sorted(files.items()):
        if name in REFUSE:
            continue
        out["decode"][name] = {how: {"shape": list(rgb.shape),
                                     "sha256": _sha(rgb)}
                               for how, rgb in (("pil", _pil(data)),
                                                ("cv2", _cv2(data)))}
        if webp.parse(data).alpha is not None:
            a = _pil_alpha(data)
            out["alpha"][name] = {"shape": list(a.shape), "sha256": _sha(a)}
    return out


def write_fixtures():
    FIXTURES.mkdir(exist_ok=True)
    files = webp_fixtures()
    for name, data in files.items():
        (FIXTURES / name).write_bytes(data)
    (FIXTURES / "digests.json").write_text(json.dumps(_digests(files),
                                                      indent=1) + "\n")


def test_webp_fixtures_rebuilt():
    """The committed fixtures are PIL's and `vp8_frame`'s bytes for their
    seeds, digests.json holds PIL's and cv2's decodes of them (equal), the
    port gives the same digests, the lossless ones by the plain version
    too and the lossy ones with the plain version's coefficients, and
    the refused files are refused, naming the cause."""
    files = webp_fixtures()
    assert sorted(p.name for p in FIXTURES.iterdir()) == sorted(
        [*files, "digests.json"])
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 400_000
    for name, data in files.items():
        assert (FIXTURES / name).read_bytes() == data, name
    golden = json.loads((FIXTURES / "digests.json").read_text())
    assert golden == json.loads(json.dumps(_digests(files)))
    for name, by_how in golden["decode"].items():
        assert by_how["pil"] == by_how["cv2"], name
        data = files[name]
        got = webp.decode_webp(data)
        assert [list(got.shape), _sha(got)] == [by_how["pil"]["shape"],
                                                by_how["pil"]["sha256"]], name
        f = webp.parse(data)
        if f.lossless:
            _same(webp.decode_webp_plain(data), got)
        else:
            for a, b in zip(webp.vp8_coefficients(data),
                            webp.vp8_coefficients_plain(data)):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        if f.alpha is not None:
            payload = data[f.alpha[0]:sum(f.alpha)]
            a = webp.decode_alpha(payload, f.width, f.height)
            _same(webp.decode_alpha_plain(payload, f.width, f.height), a)
            assert [list(a.shape), _sha(a)] == [
                golden["alpha"][name]["shape"],
                golden["alpha"][name]["sha256"]], name
    assert sorted(golden["alpha"]) == sorted(
        n for n in golden["decode"] if webp.parse(files[n]).alpha)
    animated = [n for n in golden["decode"] if webp.parse(files[n]).canvas]
    assert len(animated) == 5
    for name, match in golden["refuse"].items():
        with pytest.raises(webp.WebPError, match=match):
            webp.decode_webp(files[name])
        assert _reads(_pil, files[name]) is None
        assert _reads(_cv2, files[name]) is None


# -- against PIL and cv2 ------------------------------------------------------

@pytest.mark.parametrize("quality,method,size", [
    (5, 0, (7, 5)), (20, 1, (15, 17)), (40, 2, (32, 32)), (60, 3, (9, 33)),
    (75, 4, (50, 47)), (85, 5, (16, 80)), (95, 6, (31, 1)),
    (100, 4, (1, 31))])
def test_lossy_files(quality, method, size):
    """Seeded images through PIL's encoder at each quality band and
    method, odd and whole-macroblock sizes: the RGB of PIL and cv2, the
    plain parse's coefficients."""
    img = golden_input(quality, *size)
    data = _save(img, quality=quality, method=method)
    got = webp.decode_webp(data)
    _same(got, _pil(data))
    _same(got, _cv2(data))
    info, coeffs = webp.vp8_coefficients(data)
    plain = webp.vp8_coefficients_plain(data)
    assert info.tobytes() == plain[0].tobytes()
    assert coeffs.tobytes() == plain[1].tobytes()


@pytest.mark.parametrize("kind", ["2 colours", "3 colours", "4 colours",
                                  "11 colours", "16 colours", "17 colours",
                                  "256 colours", "rgb", "rgba exact",
                                  "rgba", "grey runs", "method 0"])
def test_lossless_files(kind):
    """Palettes bundling 8, 4, 2 and 1 pixels a byte, images past a
    palette, alpha exact or not, long runs (backward references, the
    colour cache): PIL's and cv2's RGB, equal to the plain version's."""
    h, w = 27, 35
    opts = dict(lossless=True)
    if "colours" in kind:
        img = _palette(len(kind), h, w, int(kind.split()[0]))
    elif kind.startswith("rgba"):
        img = _rgba(7, h, w)
        opts["exact"] = kind.endswith("exact")
    elif kind == "grey runs":
        img = np.repeat(np.repeat(golden_input(8, 7, 9)[..., :1], 4, 0), 4, 1)
        img = np.repeat(img, 3, -1)[:h, :w]
    else:
        img = golden_input(9, h, w)
        opts.update(quality=0, method=0) if kind == "method 0" else None
    data = _save(img, **opts)
    got = webp.decode_webp(data)
    _same(got, _pil(data))
    _same(got, _cv2(data))
    _same(webp.decode_webp_plain(data), got)


@pytest.mark.parametrize("kw", [
    dict(partitions=2), dict(partitions=4, segments=True),
    dict(partitions=8, simple=True), dict(simple=True, sharpness=5),
    dict(sharpness=7, level=63), dict(level=0, segments=True),
    dict(lf_deltas=(20, 0, 0, 0, -20, 0, 0, 0)),
    dict(lf_deltas=(-63, 1, 2, 3, 63, 1, 2, 3), simple=True, segments=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_vp8_writer_frames(kw):
    """Frames of what PIL's encoder never writes (token partitions, the
    simple filter, sharpness, level deltas, segments): PIL's and cv2's RGB,
    the plain parse's coefficients, the partitions asked for."""
    data = vp8_frame(len(str(kw)), 45, 37, **kw)
    got = webp.decode_webp(data)
    _same(got, _pil(data))
    _same(got, _cv2(data))
    info, coeffs = webp.vp8_coefficients(data)
    plain = webp.vp8_coefficients_plain(data)
    assert info.tobytes() == plain[0].tobytes()
    assert coeffs.tobytes() == plain[1].tobytes()
    assert (coeffs != 0).any()
    assert 1 << _partition_bits(data) == kw.get("partitions", 1)


def test_vp8_writer_draws_every_mode():
    """A 128 x 112 frame of `vp8_frame` holds every 4x4, 16x16 and chroma
    mode, skipped macroblocks, the four segments, and reads as PIL's."""
    data = vp8_frame(9, 128, 112, segments=True)
    _same(webp.decode_webp(data), _pil(data))
    info, _ = webp.vp8_coefficients(data)
    i4 = info[..., 2] == 1
    assert set(info[i4][:, 4:].reshape(-1).tolist()) == set(range(10))
    assert set(info[~i4][:, 4].tolist()) == set(range(4))
    assert set(info[..., 3].reshape(-1).tolist()) == set(range(4))
    assert set(info[..., 0].reshape(-1).tolist()) == set(range(4))
    assert info[..., 1].any() and not info[..., 1].all()


def _partition_bits(data):
    """The log2 partition count a frame header of `vp8_frame` names (its
    first partition parsed up to there by the plain boolean decoder)."""
    d = data[20:]
    br = webp._BoolReader(d, 10, (d[0] | d[1] << 8 | d[2] << 16) >> 5)
    br.value_bits(2)
    if br.value_bits(1):   # segments: map, data, deltas, 4 + 4 values
        br.value_bits(3)
        for bits in (7,) * 4 + (6,) * 4:
            if br.value_bits(1):
                br.signed(bits)
        for _ in range(3):
            if br.value_bits(1):
                br.value_bits(8)
    br.value_bits(10)
    if br.value_bits(1) and br.value_bits(1):
        for _ in range(8):
            if br.value_bits(1):
                br.signed(6)
    return br.value_bits(2)


def test_the_loop_filter_changes_the_pixels():
    """The same frame with the filter off, simple and normal: three
    different images, each PIL's."""
    images = []
    for kw in (dict(level=0), dict(simple=True, level=40),
               dict(level=40, sharpness=2)):
        data = vp8_frame(5, 40, 40, **kw)
        images.append(webp.decode_webp(data))
        _same(images[-1], _pil(data))
    assert len({im.tobytes() for im in images}) == 3


# -- mutants ------------------------------------------------------------------

def _mutant_bases():
    rng = np.random.default_rng(3)
    img = golden_input(61, 23, 29)
    rgba = np.concatenate([img, rng.integers(0, 256, (23, 29, 1),
                                             np.uint8)], -1)
    return {"lossless": _save(img, lossless=True),
            "lossy": _save(img, quality=60),
            "vp8x": _save(rgba, quality=60, icc_profile=b"icc" * 3,
                          exif=b"II*\0\x08\0\0\0\0\0\0\0\0\0"),
            "frame": vp8_frame(6, 29, 23, partitions=2, segments=True)}


def test_one_byte_mutants(monkeypatch):
    """About 300 seeded one-byte mutants (a random byte, a flipped bit, a
    cut) of a lossless, a lossy, an extended file with alpha and a
    partitioned frame: where PIL and cv2 both read one, the port reads
    their pixels; where either refuses, the port refuses (a mutant of the
    ALPH payload too); the library and the plain versions give one
    message. About 3 s."""
    rng = np.random.default_rng(2024)
    counts = {"read": 0, "refused": 0}
    for name, data in _mutant_bases().items():
        for _ in range(75):
            m = bytearray(data)
            at = int(rng.integers(0, len(data)))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                m[at] = int(rng.integers(0, 256))
            elif kind == 1:
                m[at] ^= 1 << int(rng.integers(0, 8))
            else:
                m = m[:at]
            m = bytes(m)
            p, c = _reads(_pil, m), _reads(_cv2, m)
            try:
                got = webp.decode_webp(m)
            except webp.WebPError as e:
                assert p is None or c is None, (name, at, str(e))
                counts["refused"] += 1
                try:
                    plain = (webp.decode_webp_plain if name == "lossless"
                             else webp.vp8_coefficients_plain)
                    plain(m)
                except webp.WebPError as e2:
                    assert str(e2) == str(e)
                continue
            assert p is not None and c is not None, (name, at, kind)
            _same(got, p)
            _same(got, c)
            counts["read"] += 1
    assert counts["read"] > 100 and counts["refused"] > 60, counts


@pytest.mark.parametrize("name", ["anmf_lossy_alph_blend_40x36.webp",
                                  "anim_lossless_21x19.webp"])
def test_one_byte_mutants_of_an_animation(name):
    """150 seeded one-byte mutants of an animation of hand-placed frames
    (a lossy frame with alpha at an offset, then a lossless one) and of
    PIL's lossless animation: read as both libraries read them, refused
    where either refuses (a broken later frame too), the lossless
    animation's refusals and reads through the plain version alike. About
    2 s."""
    data = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(20)
    counts = {"read": 0, "refused": 0}
    for _ in range(150):
        m = bytearray(data)
        at = int(rng.integers(0, len(data)))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            m[at] = int(rng.integers(0, 256))
        elif kind == 1:
            m[at] ^= 1 << int(rng.integers(0, 8))
        else:
            m = m[:at]
        m = bytes(m)
        p, c = _reads(_pil, m), _reads(_cv2, m)
        lossless = "lossless" in name
        try:
            got = webp.decode_webp(m)
        except webp.WebPError as e:
            assert p is None or c is None, (at, kind, str(e))
            counts["refused"] += 1
            if lossless:
                with pytest.raises(webp.WebPError) as e2:
                    webp.decode_webp_plain(m)
                assert str(e2.value) == str(e)
            continue
        assert p is not None and c is not None, (at, kind)
        _same(got, p)
        _same(got, c)
        if lossless:
            _same(webp.decode_webp_plain(m), got)
        counts["read"] += 1
    assert counts["read"] > 40 and counts["refused"] > 40, counts


def test_alpha_unfilters_and_the_lossless_alpha_stream():
    """`decode_alpha` against `decode_alpha_plain` and PIL's alpha: raw
    payloads through each of the four filters at widths 1-31 (the
    gradient's clipping at both ends), PIL's compressed payloads under
    each filter's bits, and the header bytes and sizes libwebp refuses,
    one message from both."""
    rng = np.random.default_rng(21)
    for h, w in ((1, 1), (3, 1), (1, 7), (9, 31), (17, 5)):
        alpha = rng.integers(0, 256, (h, w), np.uint8)
        alpha[:, ::3] = rng.choice([0, 255], (h, len(range(0, w, 3))))
        for method in range(4):
            payload = bytes([method << 2]) + (
                alpha if method == 0 else _filtered(alpha, method)).tobytes()
            got = webp.decode_alpha(payload, w, h)
            _same(got, alpha)
            _same(webp.decode_alpha_plain(payload, w, h), got)
    lossy = _save(_rgba(22, 19, 27), quality=60)
    at, size = _alph(lossy)
    for method in range(4):
        payload = bytes([lossy[at] & 0xF3 | method << 2]) \
            + lossy[at + 1:at + size]
        data = _with_alph(lossy, payload)
        got = webp.decode_alpha(payload, 27, 19)
        _same(got, np.asarray(Image.open(io.BytesIO(data)))[..., 3])
        _same(webp.decode_alpha_plain(payload, 27, 19), got)
        _same(webp.decode_webp(data), _pil(data))
    for payload, match in ((b"\x00", "an ALPH chunk of 1 bytes"),
                           (b"\x02" + bytes(9), "header byte of 0x02"),
                           (b"\x20" + bytes(9), "header byte of 0x20"),
                           (b"\x40" + bytes(9), "header byte of 0x40"),
                           (b"\x00" + bytes(9), "raw alpha data of 9 bytes "
                            "for 513 pixels")):
        for fn in (webp.decode_alpha, webp.decode_alpha_plain):
            with pytest.raises(webp.WebPError, match=match):
                fn(payload, 27, 19)
        data = _with_alph(lossy, payload)
        assert _reads(_pil, data) is None and _reads(_cv2, data) is None


def test_alpha_stream_ending_within_its_last_symbol():
    """Compressed ALPH payloads of PIL's (2-200 alpha levels, each alpha
    filter), cut by 0-11 bytes and with bytes near their end replaced: each
    file read or refused as PIL and cv2 read it. Among them are streams
    whose last symbol runs past their end, which libwebp reads where it
    takes DecodeAlphaData (colour indexing alone, no colour cache,
    one-symbol red, blue and alpha codes) and refuses elsewhere: the
    plain version with and without that rule disagrees on some of them,
    so they are in the sweep. About 2 s."""
    rng = np.random.default_rng(0)
    counts = {"read": 0, "refused": 0, "the rule decides": 0}
    h, w = 19, 27
    for trial in range(12):
        levels = (2, 3, 5, 16, 200)[trial % 5]
        alpha = rng.integers(0, 256, levels)[rng.integers(0, levels, (h, w))]
        rgba = np.concatenate([golden_input(trial, h, w),
                               alpha[..., None].astype(np.uint8)], -1)
        still = _save(rgba, quality=60,
                      alpha_filter=("none", "fast", "best")[trial % 3])
        at, size = _alph(still)
        payload = still[at:at + size]
        cases = [payload[:size - cut] for cut in range(12)]
        for _ in range(40):
            m = bytearray(payload)
            m[size - 1 - int(rng.integers(0, 8))] = int(rng.integers(0, 256))
            cases.append(bytes(m))
        for case in cases:
            data = _with_alph(still, case)
            p, c = _reads(_pil, data), _reads(_cv2, data)
            try:
                got = webp.decode_webp(data)
            except webp.WebPError:
                assert p is None or c is None
                counts["refused"] += 1
            else:
                _same(got, p)
                _same(got, c)
                counts["read"] += 1
            ends = []
            for rule in (False, True):
                try:
                    webp._lossless_stream(case[1:], w, h, rule)
                    ends.append("read")
                except webp._Refused as e:
                    ends.append(e.args[0])
            counts["the rule decides"] += ends[0] != ends[1]
    assert counts["read"] > 300 and counts["refused"] > 50, counts
    assert counts["the rule decides"] > 5, counts


# -- the container ------------------------------------------------------------

def _simple():
    return _save(golden_input(71, 11, 13), lossless=True)


def _vp8x(flags=0x08, chunks=None, canvas=(13, 11), size=10):
    simple = _simple()
    image = simple[12:]
    body = (b"VP8X" + struct.pack("<I", size) + bytes([flags, 0, 0, 0])
            + (canvas[0] - 1).to_bytes(3, "little")
            + (canvas[1] - 1).to_bytes(3, "little") + b"\0" * (size - 10)
            + b"".join(chunks(image) if chunks else [image]))
    return _resize_riff(body)


def _chunk(kind, payload):
    return kind + struct.pack("<I", len(payload)) + payload \
        + b"\0" * (len(payload) & 1)


CONTAINERS = {   # name: (file, the refusal's words, or None where read)
    "odd chunk, its pad byte": (lambda: _vp8x(chunks=lambda im: [
        _chunk(b"ICCP", b"abc"), im, _chunk(b"XMP ", b"<x/>")]), None),
    "unknown chunks": (lambda: _vp8x(chunks=lambda im: [
        _chunk(b"ABCD", b"12345"), im, _chunk(b"ZZZZ", b"")]), None),
    "bytes after the RIFF chunk": (lambda: _simple() + b"trailing", None),
    "ANIM after the image": (lambda: _vp8x(chunks=lambda im: [
        im, _chunk(b"ANIM", bytes(6))]), None),
    "not RIFF/WEBP": (lambda: b"RIFF" + _simple()[4:8] + b"WEBQ"
                      + _simple()[12:], "no RIFF / WEBP signature"),
    "under 32 bytes": (lambda: _simple()[:20] + b"\0" * 8,
                       "cv2 reads none under 32"),
    "RIFF size past the file": (lambda: _patch(_simple(), 4, struct.pack(
        "<I", len(_simple()))), "truncated: the RIFF chunk says"),
    "RIFF size under 12": (lambda: _patch(_simple(), 4, struct.pack("<I", 8)),
                           "a RIFF size of 8 bytes"),
    "first chunk unknown": (lambda: _resize_riff(_chunk(b"ICCP", b"ab")
                                                 + _simple()[12:]),
                            "the first chunk is b'ICCP'"),
    "VP8X of 12 bytes": (lambda: _vp8x(size=12), "a VP8X chunk of 12 bytes"),
    "VP8X flag bit 0": (lambda: _vp8x(flags=0x09), "VP8X flags 0x09"),
    "VP8X animation flag": (lambda: _vp8x(flags=0x0A), "an image chunk "
                            "outside the ANMF chunks of an animated file"),
    "ANIM before the image": (lambda: _vp8x(chunks=lambda im: [
        _chunk(b"ANIM", bytes(6)), im]), "an image chunk after an ANIM "
        "chunk"),
    "ANMF": (lambda: _vp8x(chunks=lambda im: [im, _chunk(b"ANMF", bytes(16))]),
             "an ANMF chunk before the ANIM chunk"),
    "ANIM, then an ANMF of no frame": (lambda: _vp8x(chunks=lambda im: [
        im, _chunk(b"ANIM", bytes(6)), _chunk(b"ANMF", bytes(16)),
        _chunk(b"ZZZZ", b"")]), None),
    "two images": (lambda: _vp8x(chunks=lambda im: [im, _chunk(b"EXIF", b"x"),
                                                   im]), "a second image"),
    "canvas size": (lambda: _vp8x(canvas=(13, 12)),
                    "a 13 x 11 image on a VP8X canvas of 13 x 12"),
    "stray bytes": (lambda: _vp8x(chunks=lambda im: [im, b"1234"]),
                    "4 stray bytes"),
    "chunk past the RIFF": (lambda: _vp8x(chunks=lambda im: [
        im, b"EXIF" + struct.pack("<I", 99) + b"x"]), "runs past the RIFF"),
    "ALPH then VP8L": (lambda: _vp8x(flags=0x10, chunks=lambda im: [
        _chunk(b"ALPH", b"\0"), im]), "an ALPH chunk beside a VP8L image"),
    "ALPH alone": (lambda: _vp8x(flags=0x10, chunks=lambda im: [
        _chunk(b"ALPH", b"\0")]), "an ALPH chunk without an image"),
    "VP8 not a key frame": (lambda: _patch(_save(golden_input(72, 8, 8),
                                                 quality=50), 20, b"\x01"),
                            "not a key frame"),
    "VP8 start code": (lambda: _patch(_save(golden_input(72, 8, 8),
                                            quality=50), 23, b"\x9c"),
                       "no VP8 start code"),
    "VP8L version": (lambda: _patch(_simple(), 24, bytes([_simple()[24]
                                                          | 0x20])),
                     "VP8L version 1"),
}


@pytest.mark.parametrize("name", list(CONTAINERS))
def test_container(name):
    """Hand-made containers: odd sizes and their pad byte, unknown and
    trailing chunks read as PIL and cv2 read them; each refusal names its
    cause, and PIL or cv2 refuses the file too (the three chunks of an
    animation in a still file among them: PIL's demuxer refuses an image
    after ANIM or in an animated file, and an ANMF before ANIM)."""
    make, match = CONTAINERS[name]
    data = make()
    p, c = _reads(_pil, data), _reads(_cv2, data)
    if match is None:
        got = webp.decode_webp(data)
        _same(got, p)
        _same(got, c)
        return
    with pytest.raises(webp.WebPError, match=match):
        webp.decode_webp(data)
    assert p is None or c is None


# A lossless header of 2^30 x 2^30 on five one-symbol codes, and a lossy
# frame header of 16383 x 16383: the first buffer of hw_webp_rgb (the
# frame's RGB, 3 * 2^60 bytes; 805 MB, in a process whose address space may
# grow by 128 MiB) fails to allocate before any pixel is read.
NO_MEMORY = """
import ctypes, resource, struct
import numpy as np
from hifidiff_tpu_torch.data import host
from hifidiff_tpu_torch.data.image_files import vp8_frame
lib = host.library()
detail = (ctypes.c_int * 2)()
out = np.zeros(3, np.uint8)
bits = [0, 0, 0] + [1, 0, 0, 0] * 5           # no transform, cache, meta
stream = bytes(5) + bytes(sum(b << i for i, b in enumerate(bits[k:k + 8]))
                          for k in range(0, len(bits), 8))
code = lib.hw_webp_rgb(stream, len(stream), 1, 1 << 30, 1 << 30, None, 0,
                       1, 1, 0, 0, out.ctypes.data, detail)
assert code == host.NO_MEMORY, code
frame = bytearray(vp8_frame(1, 16, 16)[20:])
frame[6:10] = struct.pack("<HH", 16383, 16383)
vm = next(int(ln.split()[1]) for ln in open("/proc/self/status")
          if ln.startswith("VmSize:")) * 1024
resource.setrlimit(resource.RLIMIT_AS, (vm + (1 << 27), vm + (1 << 27)))
code = lib.hw_webp_rgb(bytes(frame), len(frame), 0, 16383, 16383, None, 0,
                       1, 1, 0, 0, out.ctypes.data, detail)
assert code == host.NO_MEMORY, code
print("ok")
"""


def test_host_library_returns_no_memory():
    """An allocation that fails inside webp.cc comes back as
    `host.NO_MEMORY` (and `WebPError` naming it), not as a C++ exception
    through ctypes."""
    res = subprocess.run([sys.executable, "-c", NO_MEMORY], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.split() == ["ok"], res.stderr
    assert "out of memory" in str(webp._refusal(host.NO_MEMORY))


# -- the JAX package ----------------------------------------------------------

@pytest.fixture
def cv2_own():
    """cv2's own resize algorithm for the JAX package's calls (IPP off)."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _compare(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, str):
                assert got[k] == v
                continue
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].tobytes() == v.tobytes(), (i, k)


def _cmyk_jpeg(img, **opts):
    """PIL's CMYK JPEG of an RGB image (K from the darkest of C, M, Y)."""
    cmy = 255 - img
    cmyk = np.concatenate([cmy, cmy.min(-1, keepdims=True) // 2], -1)
    out = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(out, "JPEG", quality=90, **opts)
    return out.getvalue()


def _mixed(rng, h, w):
    """A lossy, a lossless and an extended (alpha, EXIF orientation 6)
    WebP file, a PNG, a JPEG and a BMP of seeded images, and a lossy
    animation with alpha and a CMYK JPEG."""
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    img = cv2.GaussianBlur(img, (5, 5), 0)
    rgba = np.concatenate([img, rng.integers(0, 256, (h, w, 1), np.uint8)],
                          -1)
    jpg = io.BytesIO()
    Image.fromarray(img).save(jpg, "JPEG", quality=90)
    exif = b"II*\0\x08\0\0\0\1\0\x12\x01\3\0\1\0\0\0\6\0\0\0\0\0\0\0"
    return [_save(img, quality=70), _save(img[::-1], lossless=True),
            _save(rgba, quality=90, exif=exif), png_file(img, 8, 2),
            jpg.getvalue(), bmp_file(img, 24),
            _animation([rgba, rgba[::-1]], quality=75), _cmyk_jpeg(img)]


def test_celeba_mixed_directory_against_jax(tmp_path):
    """`CelebAHQDataset` on a directory mixing WebP (lossy, lossless, with
    alpha and an EXIF orientation PIL ignores, animated) with PNG, JPEG
    (CMYK too) and BMP: every item bit-equal to the JAX class's."""
    from hifidiff_tpu.data import pretraining as jpretraining
    from hifidiff_tpu_torch.data import pretraining

    rng = np.random.default_rng(16)
    for j, data in enumerate(_mixed(rng, 50, 44) + _mixed(rng, 37, 61)):
        ext = {b"RI": ".webp", b"\x89P": ".png", b"\xff\xd8": ".jpg",
               b"BM": ".bmp"}[data[:2]]
        (tmp_path / f"{j:05d}{ext}").write_bytes(data)
    _compare(pretraining.CelebAHQDataset(str(tmp_path), size=32),
             jpretraining.CelebAHQDataset(str(tmp_path), size=32))


def _oriented(rng, h, w, k):
    """The k-th file of an oriented tree: PNG, JPEG, WebP (lossy and
    lossless), a CMYK JPEG and a lossless WebP animation in turn, each
    with EXIF orientation k % 8 + 1 (PIL writes the eXIf chunk, the APP1
    segment, the EXIF chunk)."""
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                           (5, 5), 0)
    exif = Image.Exif()
    exif[0x0112] = k % 8 + 1
    if k % 6 == 4:
        return _cmyk_jpeg(img, exif=exif)
    fmt, opts = (("PNG", {}), ("JPEG", dict(quality=90)),
                 ("WEBP", dict(quality=80)),
                 ("WEBP", dict(lossless=True)),
                 None,
                 ("WEBP", dict(lossless=True, save_all=True,
                               append_images=[Image.fromarray(img[::-1])])))[
        k % 6]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, exif=exif, **opts)
    return buf.getvalue()


def test_multipie_oriented_tree_against_jax(tmp_path, cv2_own):
    """The Multi-PIE sets on a tree whose `.png` paths hold PNG, JPEG (CMYK
    too) and WebP files (animations too) at every EXIF orientation (cv2
    and PIL read by content): the cv2 sites (`MultiPIEDataset`'s input and
    GT, the IDC set, Multi-PIE HQ) turn them as `cv2.imread` does and read
    CMYK by cv2's rule, the PIL sites do not turn them and read CMYK by
    PIL's, each item bit-equal to the JAX classes'."""
    from hifidiff_tpu.data import multipie as jmultipie
    from hifidiff_tpu.data import pretraining as jpretraining
    from hifidiff_tpu_torch.data import multipie, pretraining

    rng = np.random.default_rng(17)
    i = 0
    for pid in ("p1", "p2"):
        for angle in ("11_0", "12_0", "08_0", "19_0", "05_1", "05_0"):
            for light in ("00", "01"):
                path = tmp_path / "train" / pid / angle / f"{light}.png"
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_bytes(_oriented(rng, 40, 36, i))
                i += 1
    turned = [p for p in tmp_path.rglob("*.png")
              if cv2.imread(str(p)).shape[:2] == (36, 40)]
    assert len(turned) >= 8
    kw = dict(split="train", model_type="uni", size=32, use_blind=False,
              seed=3)
    _compare(multipie.MultiPIEDataset(str(tmp_path), **kw),
             jmultipie.MultiPIEDataset(str(tmp_path), **kw))
    _compare(multipie.MultiPIEIDCDataset(str(tmp_path), split="train",
                                         size=32, seed=5),
             jmultipie.MultiPIEIDCDataset(str(tmp_path), split="train",
                                          size=32, seed=5))
    _compare(pretraining.MultiPIEHQDataset(str(tmp_path), size=32),
             jpretraining.MultiPIEHQDataset(str(tmp_path), size=32))
    _compare(multipie.MultiPIEInferenceDataset(str(tmp_path), split="train",
                                               model_type="m2f", size=32),
             jmultipie.MultiPIEInferenceDataset(str(tmp_path), split="train",
                                                model_type="m2f", size=32))


if __name__ == "__main__":
    write_fixtures()
