"""The port's WebP reader: `decode_webp`, bound to the host library built
from `csrc/host/webp.cc` (`data/host.py`), and its plain versions.

`decode_webp` gives what libwebp 1.6 gives, bit for bit, as RGB: what
PIL's `Image.open(f).convert("RGB")` (its WebPAnimDecoder) and cv2's
`imdecode(buf, IMREAD_COLOR)` (its WebPDecode, flipped to RGB; its
WebPAnimDecoder for a file with the VP8X animation flag) read, which agree
on every still image and every animation's first frame. Lossless (VP8L)
and lossy (VP8) files, simple or extended (VP8X) with ICCP, EXIF, XMP,
ALPH and unknown chunks, odd chunk sizes with their pad byte, any size up
to 16383 x 16383. The alpha channel is dropped, as both libraries' RGB
drops it.

Animated files (ANIM and ANMF chunks, the VP8X animation flag): the
first frame, as WebPAnimDecoder composes it, measured against both
libraries: drawn at its ANMF offset on a zero canvas of the VP8X size,
its pixels as they are (libwebp blends no key frame, whatever the frame's
blend bit says; the ANIM background is never drawn). Every frame is
checked as libwebp's demuxer checks it (ParseAnimationFrame, StoreFrame,
IsValidExtendedFormat: an ANIM chunk before the frames, each frame's
chunks inside its ANMF chunk, its ALPH chunk before its image, the image
on the canvas), so a broken later frame refuses the file, though only
the first frame is decoded.

The ALPH chunk (alpha_dec.c) is decoded wherever a library decodes it,
since its RGB never depends on it but a stream libwebp refuses makes
the decode fail: an animation frame's, and a still image's ALPH chunk
before the image (cv2's WebPDecode decodes it whatever the VP8X alpha
flag says). Raw or lossless-compressed, the four filters, the
pre-processing bit (no dithering: neither library asks for it).

The container is checked as both libraries check it, and a file either
refuses is refused (`WebPError`, a ValueError naming the cause): PIL's
demuxer (a RIFF size past the file; a first chunk other than VP8, VP8L,
VP8X; chunks past the RIFF size; 1-7 stray bytes inside it; a second
image; VP8X flags past the defined ones; an image whose size is not the
VP8X canvas; an image after an ANIM chunk or outside the ANMF chunks of
an animated file; an ANMF before ANIM) and libwebp's WebPDecode, which cv2
calls (files under 32 bytes, which cv2 does not read; a VP8X chunk of
other than 10 bytes; a frame header that is not a shown key frame with
the VP8 start code).

The bitstreams are decoded from the image chunk's payload and pad byte,
as the demuxer hands them to the decoder: a bitstream that needs bytes
past them is refused (WebPDecode, which sees the bytes up to the end of
the file, reads the same pixels from any bitstream that does not).

`decode_webp_plain` is the whole lossless decode in Python and numpy, the
library's plain version for VP8L, bit for bit equal to it.
`vp8_coefficients` exports what the library's lossy decode parses (each
macroblock's segment, skip flag, modes and dequantized coefficients) and
`vp8_coefficients_plain` parses the same in Python, from the boolean
decoder on. The lossy pixel path after them (prediction, IDCT, loop
filter, upsampling, YUV -> RGB) has no plain version: it is held to PIL
and cv2, and to golden digests where neither exists. `decode_alpha` is
the library's ALPH decode alone and `decode_alpha_plain` its plain
version. Only tests and chip_smoke.py call the plain versions; no path of
the port falls back to them.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import numpy as np

from hifidiff_tpu_torch.data import host

_MAX_CHUNK = 0xFFFFFFFF - 8 - 1   # libwebp's MAX_CHUNK_PAYLOAD
_MAX_AREA = 1 << 32               # libwebp's MAX_IMAGE_AREA
_KNOWN_FLAGS = 0x3E               # ALPHA | ANIMATION | EXIF | ICCP | XMP
_ANIMATION, _EXIF, _ALPHA_FLAG = 0x02, 0x08, 0x10
_CV2_MIN_SIZE = 32                # cv2's WEBP_HEADER_SIZE


class WebPError(ValueError):
    """A WebP file the decoder cannot read, with the reason."""


# the library's and the plain versions' refusals, by code
_MESSAGES = {
    1: "the lossless bitstream ends early",
    2: "an invalid Huffman code in the lossless bitstream",
    3: "lossless transform {0} appears twice",
    4: "a lossless colour cache of {0} bits",
    5: "a lossless backward reference outside the image",
    11: "the first partition's {0} bytes are past the {1} of the frame",
    12: "the segment header runs past the first partition",
    13: "the filter header runs past the first partition",
    14: "the token partitions' sizes are past the frame",
    15: "the first partition ends early, at macroblock row {0}",
    16: "a token partition ends early, at macroblock ({0}, {1})",
    26: "an ALPH chunk of {0} bytes: no alpha data",
    27: "an ALPH header byte of {0:#04x}: a compression, pre-processing or "
        "reserved value libwebp refuses",
    28: "raw alpha data of {0} bytes for {1} pixels",
}
_ALPH_CODES = 20   # + a lossless code: that refusal in an ALPH stream


class _Refused(Exception):
    """A refusal inside the plain decoders: (code, *detail)."""


def _refusal(code: int, detail=(0, 0)) -> WebPError:
    if code == host.NO_MEMORY:
        return WebPError("out of memory decoding the WebP file")
    if _ALPH_CODES < code < _ALPH_CODES + 6:
        return WebPError("the ALPH chunk's stream: " + _MESSAGES[
            code - _ALPH_CODES].format(*detail))
    if code not in _MESSAGES:
        return WebPError(f"webp.cc returned {code}")
    return WebPError(_MESSAGES[code].format(*detail))


class Frame(NamedTuple):
    """What the container holds: the image chunk's kind ("VP8 " or
    "VP8L"), the offset of its payload, the bytes the decoder reads (the
    payload and pad byte), the file's length, the image's size, the EXIF
    chunk cv2 reads (None without one), the (offset, size) of the ALPH
    payload the decoder reads (None without one), and, for an animation's
    first frame, the (width, height) of the canvas it is drawn on and its
    place there (None and (0, 0) for a still image)."""
    kind: bytes
    offset: int
    length: int
    file_length: int
    width: int
    height: int
    exif: bytes | None
    alpha: tuple[int, int] | None = None
    canvas: tuple[int, int] | None = None
    x: int = 0
    y: int = 0

    @property
    def lossless(self) -> bool:
        return self.kind == b"VP8L"


# libwebp's constant tables (RFC 6386's), as webp.cc has them: the DC and
# AC quantizer steps by index; the default token probabilities and the
# probabilities of updating them, [type][band][context][node]; the 4x4 mode
# probabilities, [above][left][node] in libwebp's mode order; VP8L's
# distance map, y << 4 | (8 - x) of each of its 120 codes.
_DC_TABLE = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c"
    "1d1e1f20212223242525262728292a2b2c2d2e2e2f303132333435363738393a"
    "3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f50515253545556575859"
    "5b5d5f6062646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d")
_COEFFS_PROBA0 = bytes.fromhex(
    "8080808080808080808080808080808080808080808080808080808080808080"
    "80fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff80"
    "80800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb"
    "80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680"
    "808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ff"
    "ffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3"
    "ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ff"
    "c2e080808080800101ff8080808080808080f601ff8080808080808080ff8080"
    "8080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc780808051"
    "63b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080"
    "802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff80"
    "80801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea8080"
    "808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff"
    "ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff80"
    "80808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1"
    "b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933db"
    "ffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5"
    "f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff8080808080"
    "80d53efaffff808080808080375dff8080808080808080808080808080808080"
    "808080808080808080808080808080808080808080808080ca18d5ebbabfdca0"
    "f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff7"
    "9fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9db"
    "f0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fc"
    "cccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8"
    "ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179"
    "ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd80808001"
    "01ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
_COEFFS_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffb0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffff"
    "fffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff"
    "fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffff"
    "fffffffffff8fefffffffffffffffffbfffeffffffffffffffffffffffffffff"
    "fffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff"
    "fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffee"
    "fdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff"
    "fffffffffffffffffffffffffffdfefffffffffffffffffcffffffffffffffff"
    "fffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffff"
    "fffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feff"
    "fffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefe"
    "fffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefe"
    "fffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffff8ffffffffffffff"
    "fffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffff"
    "fffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffff"
    "fffffffffffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdff"
    "fffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff"
    "fffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffffffff"
    "fdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
_BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabda"
    "bd110d98721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa"
    "2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265"
    "6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b"
    "1a9249a631179d412669a033341f7380684f0c1bd9ff5711075744472c72330f"
    "ba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7"
    "75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a62"
    "40221674ce17222ba6496b36201a3301512b1f44196a1640ab24e17222131566"
    "84bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b43"
    "2d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6"
    "5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e"
    "16188001361125412049731c801780cd2803097333c01206df572509733b4d40"
    "152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a"
    "8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b"
    "33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58"
    "685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a55"
    "8065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c045"
    "3c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f"
    "069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527"
    "9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404"
    "f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b"
    "769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc3"
    "80300418")
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a"
    "242c58454b343c035759131d565a232d444c555b333d68026769121e666a222e"
    "545c434d656b323e78017779535d111f646c424e767a212f757b313f636d525e"
    "00747c414f1020626e30737d515f40727e616f50717f6070")
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
    56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78,
    80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104,
    106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137,
    140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177,
    181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229,
    234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,)


def _u32(data: bytes, at: int) -> int:
    return struct.unpack_from("<I", data, at)[0]


def _u24(data: bytes, at: int) -> int:
    return data[at] | data[at + 1] << 8 | data[at + 2] << 16


def _image_size(kind: bytes, payload: bytes, size: int):
    """(width, height) of a VP8 or VP8L bitstream, refused as libwebp's
    VP8GetInfo / VP8LGetInfo refuse it; `size` is the chunk's size field."""
    if kind == b"VP8 ":
        if len(payload) < 10:
            raise WebPError(f"a VP8 chunk of {len(payload)} bytes: shorter "
                            "than a frame header")
        tag = payload[0] | payload[1] << 8 | payload[2] << 16
        if payload[3:6] != b"\x9d\x01\x2a":
            raise WebPError("no VP8 start code")
        if tag & 1:
            raise WebPError("a VP8 frame that is not a key frame")
        if (tag >> 1) & 7 > 3:
            raise WebPError(f"VP8 profile {(tag >> 1) & 7}")
        if not (tag >> 4) & 1:
            raise WebPError("a VP8 frame that is not shown")
        if tag >> 5 >= size:
            raise WebPError(f"a first partition of {tag >> 5} bytes in a "
                            f"VP8 chunk of {size}")
        w = (payload[6] | payload[7] << 8) & 0x3FFF
        h = (payload[8] | payload[9] << 8) & 0x3FFF
        if not w or not h:
            raise WebPError(f"a VP8 frame of {w} x {h}")
        return w, h
    if len(payload) < 5:
        raise WebPError(f"a VP8L chunk of {len(payload)} bytes: shorter than "
                        "its header")
    if payload[0] != 0x2F:
        raise WebPError("no VP8L signature")
    if payload[4] >> 5:
        raise WebPError(f"VP8L version {payload[4] >> 5}")
    bits = int.from_bytes(payload[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def _chunk(data: bytes, pos: int, end: int):
    """(kind, size, padded size) of the chunk at `pos`, refused where it
    runs past the RIFF chunk."""
    kind, size = data[pos:pos + 4], _u32(data, pos + 4)
    padded = size + (size & 1)
    if size > _MAX_CHUNK or padded > end - pos - 8:
        raise WebPError(f"a {kind!r} chunk of {size} bytes runs past the "
                        "RIFF chunk")
    return kind, size, padded


def _next(pos: int, end: int) -> bool:
    """Whether another chunk follows at `pos`: the demuxer refuses 1-7
    bytes left inside the RIFF chunk."""
    if pos == end:
        return False
    if end - pos < 8:
        raise WebPError(f"{end - pos} stray bytes at the end of the RIFF "
                        "chunk")
    return True


def _store_frame(data: bytes, pos: int, end: int):
    """libwebp demux's StoreFrame from `pos`: an ALPH chunk and the image
    chunk after it. Returns ((kind, offset, size, padded) or None, the
    (offset, size) of the ALPH payload or None, whether it followed the
    image, the position after them)."""
    image, alpha, alpha_after = None, None, False
    while True:
        kind, size, padded = _chunk(data, pos, end)
        if kind == b"ALPH":
            if alpha is not None:
                break
            alpha, alpha_after = (pos + 8, size), image is not None
        elif kind in (b"VP8 ", b"VP8L"):
            if kind == b"VP8L" and alpha is not None:
                raise WebPError("an ALPH chunk beside a VP8L image")
            if image is not None:
                break
            _image_size(kind, data[pos + 8:pos + 8 + padded], size)
            image = (kind, pos + 8, size, padded)
        else:
            break
        pos += 8 + padded
        if not _next(pos, end):
            break
    return image, alpha, alpha_after, pos


def _anmf(data: bytes, pos: int, end: int, size: int, padded: int):
    """libwebp demux's ParseAnimationFrame of the ANMF chunk at `pos`:
    ((x, y), `_store_frame`'s image, ALPH and order) and the position
    after them, where the top-level walk goes on (inside the ANMF chunk
    where unknown chunks follow the frame's)."""
    if padded < 16:
        raise WebPError(f"an ANMF chunk of {size} bytes")
    at = pos + 8
    x, y = 2 * _u24(data, at), 2 * _u24(data, at + 3)
    w, h = 1 + _u24(data, at + 6), 1 + _u24(data, at + 9)
    if w * h >= _MAX_AREA:
        raise WebPError(f"an ANMF frame of {w} x {h}")
    start = at + 16
    if end - start < 8:
        raise WebPError("an ANMF chunk at the end of the file holds no "
                        "frame")
    image, alpha, alpha_after, after = _store_frame(data, start, end)
    if after - start > padded - 16:
        raise WebPError("a frame's chunks run past its ANMF chunk")
    return (x, y), image, alpha, alpha_after, after


def parse(data: bytes) -> Frame:
    """The container of a WebP file, refused where PIL's demuxer or cv2's
    WebPDecode refuses it."""
    data = bytes(data)
    n = len(data)
    if n < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise WebPError("not a WebP file (no RIFF / WEBP signature)")
    if n < _CV2_MIN_SIZE:
        raise WebPError(f"a WebP file of {n} bytes: cv2 reads none under "
                        f"{_CV2_MIN_SIZE}")
    riff = _u32(data, 4)
    if riff < 12 or riff > _MAX_CHUNK:
        raise WebPError(f"a RIFF size of {riff} bytes")
    if riff > n - 8:
        raise WebPError(f"truncated: the RIFF chunk says {riff} bytes, the "
                        f"file holds {n - 8}")
    end = riff + 8
    first = data[12:16]
    flags, canvas, exif, alpha = 0, None, None, None
    if first in (b"VP8 ", b"VP8L"):   # an ALPH chunk after it is not read
        image = _store_frame(data, 12, end)[0]
    elif first == b"VP8X":
        size = _u32(data, 16)
        if size != 10:
            raise WebPError(f"a VP8X chunk of {size} bytes: cv2's WebPDecode "
                            "takes 10")
        if end - 20 < 10 + 8:
            raise WebPError("no chunk after the VP8X chunk")
        flags = data[20]
        canvas = 1 + _u24(data, 24), 1 + _u24(data, 27)
        if canvas[0] * canvas[1] >= _MAX_AREA:
            raise WebPError(f"a VP8X canvas of {canvas[0]} x {canvas[1]}")
        animated = bool(flags & _ANIMATION)
        image, anim, frames, pos = None, False, [], 30
        while True:
            kind, size, padded = _chunk(data, pos, end)
            if kind == b"VP8X":
                raise WebPError("a second VP8X chunk")
            if kind in (b"ALPH", b"VP8 ", b"VP8L"):
                if animated:
                    raise WebPError("an image chunk outside the ANMF chunks "
                                    "of an animated file")
                if anim:
                    raise WebPError("an image chunk after an ANIM chunk")
                if image is not None:
                    raise WebPError("a second image in a still WebP file")
                image, alpha, alpha_after, pos = _store_frame(data, pos, end)
                if image is None:
                    raise WebPError("an ALPH chunk without an image after it")
                if alpha_after:
                    if flags & _ALPHA_FLAG:
                        raise WebPError("an ALPH chunk after the image")
                    alpha = None   # neither library reads it
                if pos == end:
                    break
                continue
            if kind == b"ANMF":
                if not anim:
                    raise WebPError("an ANMF chunk before the ANIM chunk")
                place, fimage, falpha, after, pos = _anmf(data, pos, end,
                                                          size, padded)
                if animated and (fimage or falpha):
                    if frames and frames[-1][1] is None:
                        raise WebPError("a frame without an image chunk")
                    frames.append((place, fimage, falpha, after))
                if not _next(pos, end):
                    break
                continue
            if kind == b"ANIM":
                if padded < 6:
                    raise WebPError(f"an ANIM chunk of {size} bytes")
                anim = True
            elif kind == b"EXIF" and flags & _EXIF and exif is None:
                exif = data[pos + 8:pos + 8 + size]
            pos += 8 + padded
            if not _next(pos, end):
                break
        if flags & ~_KNOWN_FLAGS:
            raise WebPError(f"VP8X flags {flags:#04x}: bits the demuxer "
                            "refuses")
        if animated:
            return _first_frame(data, frames, canvas, exif)
        if image is None:
            raise WebPError("no image chunk")
    else:
        raise WebPError(f"the first chunk is {first!r}, not VP8, VP8L or "
                        "VP8X")
    kind, offset, size, padded = image
    w, h = _image_size(kind, data[offset:offset + padded], size)
    if canvas is not None and canvas != (w, h):
        raise WebPError(f"a {w} x {h} image on a VP8X canvas of {canvas[0]} "
                        f"x {canvas[1]}")
    return Frame(kind, offset, padded, n, w, h, exif, alpha)


def _first_frame(data: bytes, frames: list, canvas, exif) -> Frame:
    """The demuxer's checks of an animation's frames (IsValidExtendedFormat:
    each has an image, its ALPH chunk before it, and lies on the canvas),
    then its first frame, the one PIL and cv2 read."""
    if not frames:
        raise WebPError("an animated file without frames")
    for (x, y), image, _, alpha_after in frames:
        if image is None:
            raise WebPError("a frame without an image chunk")
        if alpha_after:
            raise WebPError("an ALPH chunk after its frame's image")
        kind, offset, size, padded = image
        w, h = _image_size(kind, data[offset:offset + padded], size)
        if x + w > canvas[0] or y + h > canvas[1]:
            raise WebPError(f"a {w} x {h} frame at ({x}, {y}) past the "
                            f"{canvas[0]} x {canvas[1]} canvas")
    (x, y), (kind, offset, size, padded), alpha, _ = frames[0]
    w, h = _image_size(kind, data[offset:offset + padded], size)
    return Frame(kind, offset, padded, len(data), w, h, exif, alpha, canvas,
                 x, y)


def decode_webp(data: bytes) -> np.ndarray:
    """A WebP file's bytes as an (H, W, 3) uint8 RGB array: a still image,
    or an animation's first frame on its canvas."""
    data = bytes(data)
    f = parse(data)
    cw, ch = f.canvas or (f.width, f.height)
    out = np.empty((ch, cw, 3), np.uint8)
    detail = (ctypes.c_int * 2)()
    body = data[f.offset:f.offset + f.length]
    alpha = None if f.alpha is None else data[f.alpha[0]:sum(f.alpha)]
    code = host.library().hw_webp_rgb(
        body, f.length, f.lossless, f.width, f.height, alpha,
        0 if alpha is None else len(alpha), cw, ch, f.x, f.y,
        out.ctypes.data, detail)
    if code:
        raise _refusal(code, detail)
    return out


def decode_alpha(payload: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk's payload as the library decodes it: (height, width)
    uint8 alpha."""
    payload = bytes(payload)
    out = np.empty((height, width), np.uint8)
    detail = (ctypes.c_int * 2)()
    code = host.library().hw_alpha(payload, len(payload), width, height,
                                   out.ctypes.data, detail)
    if code:
        raise _refusal(code, detail)
    return out


def vp8_coefficients(data: bytes):
    """What the library's lossy decode parses, per macroblock in raster
    order: `info` (mb_h, mb_w, 20) uint8 (segment, skip flag, i4x4, chroma
    mode, 16 luma modes in libwebp's numbering) and `coeffs` (mb_h, mb_w,
    25, 16) int16 (the Y2 block, then the 16 Y blocks with the WHT's DCs,
    the 4 U and the 4 V blocks, dequantized, in raster order within each
    block)."""
    data = bytes(data)
    f = parse(data)
    if f.lossless:
        raise WebPError("a lossless (VP8L) file has no VP8 coefficients")
    mb_w, mb_h = (f.width + 15) >> 4, (f.height + 15) >> 4
    info = np.zeros((mb_h, mb_w, 20), np.uint8)
    coeffs = np.zeros((mb_h, mb_w, 25, 16), np.int16)
    detail = (ctypes.c_int * 2)()
    body = data[f.offset:f.offset + f.length]
    code = host.library().hw_vp8_coefficients(
        body, f.length, info.ctypes.data, coeffs.ctypes.data, detail)
    if code:
        raise _refusal(code, detail)
    return info, coeffs


# -- the lossless decode in Python -------------------------------------------

class _Bits:
    """LSB-first bits of `data[:length]`, zeros past them; ended once more
    bits were read than it holds."""

    def __init__(self, data: bytes, length: int):
        self.data = data[:length] + bytes(8)
        self.limit = 8 * length
        self.pos = 0

    def peek(self, n: int) -> int:
        at = self.pos >> 3
        w = int.from_bytes(self.data[at:at + 8], "little")
        return (w >> (self.pos & 7)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v

    def ended(self) -> bool:
        return self.pos > self.limit


class _Code:
    """A canonical prefix code as a table of its codes' first 15 bits
    (least significant bit first): (symbol, length); or its one symbol."""

    def __init__(self, lengths):
        count = [0] * 16
        for v in lengths:
            count[v] += 1
        n = len(lengths)
        if count[0] == n or any(count[k] > 1 << k for k in range(1, 15)):
            raise _Refused(2)
        self.single = None
        if n - count[0] == 1:
            self.single = next(s for s, v in enumerate(lengths) if v)
            return
        left = 1
        for k in range(1, 16):
            left = 2 * left - count[k]
            if left < 0:
                raise _Refused(2)
        if left:
            raise _Refused(2)
        self.table, code = {}, 0
        for k in range(1, 16):
            for s in (s for s, v in enumerate(lengths) if v == k):
                rev = int(f"{code:0{k}b}"[::-1], 2)
                self.table[(rev, k)] = s
                code += 1
            code <<= 1

    def read(self, br: _Bits) -> int:
        if self.single is not None:
            return self.single
        bits = br.peek(15)
        for k in range(1, 16):
            s = self.table.get((bits & ((1 << k) - 1), k))
            if s is not None:
                br.pos += k
                return s
        raise AssertionError("a complete prefix code ends within 15 bits")


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15)


def _read_code(br: _Bits, n: int) -> _Code:
    lengths = [0] * n
    if br.read(1):
        num = br.read(1) + 1
        s = br.read(8 if br.read(1) else 1)
        if s < n:
            lengths[s] = 1
        if num == 2:
            s = br.read(8)
            if s < n:
                lengths[s] = 1
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
        code_lengths = _Code(cl)
        max_symbol = n
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > n:
                raise _Refused(2)
        symbol, prev = 0, 8
        while symbol < n:
            if max_symbol == 0:
                break
            max_symbol -= 1
            c = code_lengths.read(br)
            if c < 16:
                lengths[symbol] = c
                symbol += 1
                prev = c or prev
            else:
                repeat = br.read((2, 3, 7)[c - 16]) + (3, 3, 11)[c - 16]
                if symbol + repeat > n:
                    raise _Refused(2)
                lengths[symbol:symbol + repeat] = [prev if c == 16 else 0] \
                    * repeat
                symbol += repeat
    if br.ended():
        raise _Refused(1)
    return _Code(lengths)


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _copy_value(symbol: int, br: _Bits) -> int:
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _stream(br: _Bits, w: int, h: int, level0: bool, transforms: list,
            alpha: bool = False):
    """One entropy-coded image (the transforms first at level 0) as a list
    of w * h ARGB ints. `alpha`: an ALPH chunk's stream, whose end libwebp
    looks at only after each symbol or copy (DecodeAlphaData) where its
    only transform is colour indexing, it has no colour cache and every
    group it keeps has one-symbol red, blue and alpha codes."""
    if level0:
        seen = 0
        while br.read(1):
            kind = br.read(2)
            if seen & (1 << kind):
                raise _Refused(3, kind)
            seen |= 1 << kind
            t = {"type": kind, "xsize": w, "bits": 0, "data": None}
            if kind in (0, 1):
                t["bits"] = br.read(3) + 2
                t["data"] = _stream(br, _sub(w, t["bits"]),
                                    _sub(h, t["bits"]), False, [])
            elif kind == 3:
                colors = br.read(8) + 1
                t["bits"] = (0 if colors > 16 else 1 if colors > 4
                             else 2 if colors > 2 else 3)
                w = _sub(t["xsize"], t["bits"])
                pal = np.array(_stream(br, colors, 1, False, []),
                               np.uint32).view(np.uint8).reshape(-1, 4)
                full = np.zeros((1 << (8 >> t["bits"]), 4), np.uint8)
                full[:colors] = np.cumsum(pal, axis=0, dtype=np.uint8)
                t["data"] = full.reshape(-1).view(np.uint32)
            transforms.append(t)
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise _Refused(4, cache_bits)
    meta_bits, meta, groups = 0, None, 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = _sub(w, meta_bits)
        meta = [(v >> 8) & 0xFFFF for v in _stream(
            br, mw, _sub(h, meta_bits), False, [])]
        groups = max(meta) + 1
    sizes = (256 + 24 + (1 << cache_bits if cache_bits else 0), 256, 256,
             256, 40)
    codes = [[_read_code(br, n) for n in sizes] for _ in range(groups)]
    kept = (range(groups) if groups <= 1000 and groups <= w * h
            else sorted(set(meta)))
    lenient = alpha and [t["type"] for t in transforms] == [3] \
        and not cache_bits and all(codes[g][k].single is not None
                                   for g in kept for k in (1, 2, 3))
    cache = [0] * (1 << cache_bits)
    px = [0] * (w * h)
    i = cached = x = y = 0
    total = w * h
    while i < total and not (lenient and br.ended()):
        g = codes[0 if meta is None else
                  meta[(y >> meta_bits) * mw + (x >> meta_bits)]]
        code = g[0].read(br)
        if br.ended() and not lenient:
            break
        if code < 256:
            red, blue, a = (g[1].read(br), g[2].read(br), g[3].read(br))
            if br.ended() and not lenient:
                break
            px[i] = a << 24 | red << 16 | code << 8 | blue
            i += 1
            x += 1
        elif code < 280:
            length = _copy_value(code - 256, br)
            dcode = _copy_value(g[4].read(br), br)
            if dcode > 120:
                dist = dcode - 120
            else:
                plane = _CODE_TO_PLANE[dcode - 1]
                dist = max(1, (plane >> 4) * w + 8 - (plane & 15))
            if br.ended() and not lenient:
                break
            if i < dist or total - i < length:
                raise _Refused(5)
            for k in range(i, i + length):
                px[k] = px[k - dist]
            i += length
            x += length
        else:
            for k in range(cached, i):
                cache[((0x1E35A7BD * px[k]) & 0xFFFFFFFF)
                      >> (32 - cache_bits)] = px[k]
            cached = i
            px[i] = cache[code - 280]
            i += 1
            x += 1
        if x >= w:
            y += x // w
            x %= w
            if cache_bits:
                for k in range(cached, i):
                    cache[((0x1E35A7BD * px[k]) & 0xFFFFFFFF)
                          >> (32 - cache_bits)] = px[k]
                cached = i
    if br.ended() and (i < total or not lenient):
        raise _Refused(1)
    return px


def _average2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(v):
    return [(v >> s) & 0xFF for s in (0, 8, 16, 24)]


def _pack(cs):
    return cs[0] | cs[1] << 8 | cs[2] << 16 | cs[3] << 24


def _predict(mode: int, left: int, top: list, x: int) -> int:
    T, TL, TR = top[x], top[x - 1], top[x + 1]
    if mode == 1:
        return left
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _average2(_average2(left, TR), T)
    if mode == 6:
        return _average2(left, TL)
    if mode == 7:
        return _average2(left, T)
    if mode == 8:
        return _average2(TL, T)
    if mode == 9:
        return _average2(T, TR)
    if mode == 10:
        return _average2(_average2(left, TL), _average2(T, TR))
    if mode == 11:
        d = sum(abs(b - c) - abs(a - c) for a, b, c in zip(
            _channels(T), _channels(left), _channels(TL)))
        return T if d <= 0 else left
    if mode == 12:
        return _pack([min(255, max(0, a + b - c)) for a, b, c in zip(
            _channels(left), _channels(T), _channels(TL))])
    if mode == 13:
        return _pack([min(255, max(0, a + int((a - b) / 2))) for a, b in zip(
            _channels(_average2(left, T)), _channels(TL))])
    return 0xFF000000   # 0, and 14 and 15 as libwebp reads them


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (
        ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _inverse(t: dict, h: int, px: np.ndarray) -> np.ndarray:
    """One inverse transform on (h, width) uint32 pixels."""
    w, bits, kind = t["xsize"], t["bits"], t["type"]
    if kind == 0:
        tiles = _sub(w, bits)
        modes = [(v >> 8) & 15 for v in t["data"]]
        rows = px.tolist()
        out = [[0] * w for _ in range(h)]
        acc = 0xFF000000
        for x in range(w):
            acc = _add(rows[0][x], acc)
            out[0][x] = acc
        for y in range(1, h):
            # the previous row, and the current row's first pixel as the
            # last pixel's top-right
            row, top = out[y], out[y - 1] + [0]
            row[0] = _add(rows[y][0], top[0])
            top[w] = row[0]
            base = (y >> bits) * tiles
            for x in range(1, w):
                row[x] = _add(rows[y][x], _predict(
                    modes[base + (x >> bits)], row[x - 1], top, x))
        return np.array(out, np.uint32).reshape(h, w)
    if kind == 1:
        m = np.asarray(t["data"], np.uint32).reshape(
            _sub(h, bits), _sub(w, bits))
        m = np.repeat(np.repeat(m, 1 << bits, 0), 1 << bits, 1)[:h, :w]
        g2r = (m & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        g2b = ((m >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
        r2b = ((m >> 16) & 0xFF).astype(np.uint8).view(np.int8).astype(
            np.int32)
        green = ((px >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(
            np.int32)
        red = ((px >> 16) & 0xFF).astype(np.int32)
        blue = (px & 0xFF).astype(np.int32)
        red = (red + ((g2r * green) >> 5)) & 0xFF
        blue = blue + ((g2b * green) >> 5)
        blue = (blue + ((r2b * red.astype(np.uint8).view(np.int8)) >> 5)) \
            & 0xFF
        return (px & 0xFF00FF00) | (red.astype(np.uint32) << 16) \
            | blue.astype(np.uint32)
    if kind == 2:
        g = (px >> 8) & 0xFF
        return (px & 0xFF00FF00) | ((((px >> 16) + g) & 0xFF) << 16) \
            | ((px + g) & 0xFF)
    bpp = 8 >> bits
    x = np.arange(w)
    idx = ((px[:, x >> bits] >> 8) >> (bpp * (x & ((1 << bits) - 1)))) \
        & ((1 << bpp) - 1)
    return t["data"][idx]


def _lossless_stream(data: bytes, w: int, h: int, alpha: bool = False):
    """A level-0 lossless stream in `data` (bits from 0) as (h, w) ARGB
    uint32, its transforms inverted."""
    transforms = []
    px = _stream(_Bits(data, len(data)), w, h, True, transforms, alpha)
    px = np.array(px, np.uint32).reshape(h, -1)
    for t in reversed(transforms):
        px = _inverse(t, h, px)
    return px


def decode_webp_plain(data: bytes) -> np.ndarray:
    """`decode_webp` of a lossless file (still, or an animation whose first
    frame is lossless) in Python and numpy: its plain version. A lossy file
    raises WebPError (its plain version stops at `vp8_coefficients_plain`
    and `decode_alpha_plain`)."""
    data = bytes(data)
    f = parse(data)
    if not f.lossless:
        raise WebPError("a lossy (VP8) file: decode_webp_plain decodes "
                        "lossless ones")
    try:   # past the signature, size, alpha hint and version: parse's
        px = _lossless_stream(data[f.offset + 5:f.offset + f.length],
                             f.width, f.height)
    except _Refused as e:
        raise _refusal(e.args[0], (*e.args[1:], 0, 0)) from None
    cw, ch = f.canvas or (f.width, f.height)
    out = np.zeros((ch, cw, 3), np.uint8)
    out[f.y:f.y + f.height, f.x:f.x + f.width] = np.stack(
        [(px >> 16) & 0xFF, (px >> 8) & 0xFF, px & 0xFF], -1)
    return out


def _unfilter_alpha(rows: np.ndarray, method: int) -> np.ndarray:
    """dsp/filters.c's alpha unfilters on (h, w) uint8 rows: 0 none, 1
    horizontal, 2 vertical, 3 gradient, each row from the output row above
    it (the first row horizontally from 0)."""
    rows = np.asarray(rows, np.uint8)
    if method == 0:
        return rows.copy()
    out = np.zeros(rows.shape, np.uint8)
    prev = None
    for y, row in enumerate(rows.astype(np.int64)):
        if method == 1 or prev is None:
            start = 0 if prev is None else int(prev[0])
            out[y] = (start + np.cumsum(row)) & 0xFF
        elif method == 2:
            out[y] = (prev.astype(np.int64) + row) & 0xFF
        else:
            left = top_left = int(prev[0])
            for i, top in enumerate(prev.tolist()):
                pred = min(255, max(0, left + top - top_left))
                left = (int(row[i]) + pred) & 0xFF
                top_left = top
                out[y, i] = left
        prev = out[y]
    return out


def decode_alpha_plain(payload: bytes, width: int, height: int
                       ) -> np.ndarray:
    """`decode_alpha` in Python and numpy: its plain version."""
    payload = bytes(payload)
    try:
        if len(payload) <= 1:
            raise _Refused(26, len(payload))
        head = payload[0]
        if head & 3 > 1 or head >> 4 > 1:
            raise _Refused(27, head)
        n = width * height
        if head & 3 == 0:
            if len(payload) - 1 < n:
                raise _Refused(28, len(payload) - 1, n)
            rows = np.frombuffer(payload, np.uint8, n, 1)
        else:
            try:
                px = _lossless_stream(payload[1:], width, height, True)
            except _Refused as e:
                raise _Refused(_ALPH_CODES + e.args[0], *e.args[1:]) from None
            rows = ((px >> 8) & 0xFF).astype(np.uint8)
    except _Refused as e:
        raise _refusal(e.args[0], (*e.args[1:], 0, 0)) from None
    return _unfilter_alpha(rows.reshape(height, width), (head >> 2) & 3)


# -- the lossy parse in Python -----------------------------------------------

class _BoolReader:
    """libwebp's VP8BitReader, its 56-bit loads and end-of-data rule."""

    def __init__(self, data: bytes, start: int, size: int):
        self.data, self.buf, self.end = data, start, start + size
        self.max = start + size - 7 if size >= 8 else start
        self.range, self.value, self.bits, self.eof = 254, 0, -8, False
        self._load()

    def _load(self):
        if self.buf < self.max:
            self.value = (self.value << 56 | int.from_bytes(
                self.data[self.buf:self.buf + 7], "big")) & (1 << 64) - 1
            self.buf += 7
            self.bits += 56
        elif self.buf < self.end:
            self.value = (self.value << 8 | self.data[self.buf]) \
                & (1 << 64) - 1
            self.buf += 1
            self.bits += 8
        elif not self.eof:
            self.value = (self.value << 8) & (1 << 64) - 1
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        rng = self.range
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = (rng * prob) >> 8
        b = (self.value >> pos) & 0xFFFFFFFF > split
        if b:
            rng -= split
            self.value -= (split + 1) << pos
        else:
            rng = split + 1
        shift = 7 ^ (rng.bit_length() - 1)
        self.range = (rng << shift) - 1
        self.bits -= shift
        return int(b)

    def sign(self, v: int) -> int:
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range >> 1
        if (self.value >> pos) & 0xFFFFFFFF > split:
            self.range = (self.range - 1) | 1
            self.value -= (split + 1) << pos
            v = -v
        else:
            self.range |= 1
        self.bits -= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        for k in range(n - 1, -1, -1):
            v |= self.bit(0x80) << k
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.value_bits(1) else v


_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the intra modes, libwebp's numbering
_DC, _TM, _VE, _HE, _RD, _VR, _LD, _VL, _HD, _HU = range(10)


def _large_value(br: _BoolReader, p) -> int:
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        v = 7 + 2 * br.bit(165)
        return v + br.bit(145)
    bit1 = br.bit(p[8])
    cat = 2 * bit1 + br.bit(p[9 + bit1])
    v = 0
    for prob in _CATS[cat]:
        v += v + br.bit(prob)
    return v + 3 + (8 << cat)


def _i16(v: int) -> int:
    return (v + 0x8000) % 0x10000 - 0x8000


def _tokens(br, bands, ctx, dq, n, out):
    """GetCoeffs: fills `out` (16, natural order), returns the index after
    the last coefficient read."""
    p = bands[_BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            p = bands[_BANDS[n]][0]
            if n == 16:
                return 16
        if not br.bit(p[2]):
            v, p = 1, bands[_BANDS[n + 1]][1]
        else:
            v = _large_value(br, p)
            p = bands[_BANDS[n + 1]][2]
        out[_ZIGZAG[n]] = _i16(br.sign(v) * dq[n > 0])
        n += 1
    return 16


def _wht(dc):
    out = [0] * 16
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = (a0 + a1, a0 - a1,
                                                        a3 + a2, a3 - a2)
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        out[4 * i:4 * i + 4] = [_i16((a0 + a1) >> 3), _i16((a3 + a2) >> 3),
                                _i16((a0 - a1) >> 3), _i16((a3 - a2) >> 3)]
    return out   # the DC of Y block 4 * row + column


def vp8_coefficients_plain(data: bytes):
    """`vp8_coefficients` in Python: the frame header, the quantizers and
    token probabilities, then each macroblock's modes (the first
    partition) and tokens (its row's partition), bit for bit as the
    library parses them."""
    data = bytes(data)
    f = parse(data)
    if f.lossless:
        raise WebPError("a lossless (VP8L) file has no VP8 coefficients")
    try:
        return _parse_vp8(data[f.offset:f.offset + f.length], f)
    except _Refused as e:
        raise _refusal(e.args[0], (*e.args[1:], 0, 0)) from None


def _parse_vp8(d: bytes, f: Frame):
    tag = d[0] | d[1] << 8 | d[2] << 16
    part0, size = tag >> 5, len(d) - 10
    mb_w, mb_h = (f.width + 15) >> 4, (f.height + 15) >> 4
    if part0 > size:
        raise _Refused(11, part0, size)
    br = _BoolReader(d, 10, part0)
    rest = 10 + part0
    size -= part0
    br.value_bits(2)   # colour space, clamping type
    use_segment, update_map, absolute = br.value_bits(1), 0, 1
    quant, fstrength, seg_proba = [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = br.value_bits(1)
        if br.value_bits(1):
            absolute = br.value_bits(1)
            quant = [br.signed(7) if br.value_bits(1) else 0
                     for _ in range(4)]
            fstrength = [br.signed(6) if br.value_bits(1) else 0
                         for _ in range(4)]
        if update_map:
            seg_proba = [br.value_bits(8) if br.value_bits(1) else 255
                         for _ in range(3)]
    if br.eof:
        raise _Refused(12)
    br.value_bits(1 + 6 + 3)   # simple, level, sharpness
    if br.value_bits(1) and br.value_bits(1):   # level deltas
        for _ in range(8):
            if br.value_bits(1):
                br.signed(6)
    if br.eof:
        raise _Refused(13)
    num_parts = 1 << br.value_bits(2)
    last = num_parts - 1
    if size < 3 * last:
        raise _Refused(14)
    start, left, parts = rest + 3 * last, size - 3 * last, []
    for p in range(last):
        psize = min(int.from_bytes(d[rest + 3 * p:rest + 3 * p + 3],
                                   "little"), left)
        parts.append(_BoolReader(d, start, psize))
        start += psize
        left -= psize
    parts.append(_BoolReader(d, start, left))
    if left == 0:
        raise _Refused(14)
    base = br.value_bits(7)
    delta = [br.signed(4) if br.value_bits(1) else 0 for _ in range(5)]
    dq = []
    for s in range(4):
        q = (quant[s] + (0 if absolute else base)) if use_segment else base

        def at(table, v, top=127):
            return table[min(max(v, 0), top)]
        dq.append(((at(_DC_TABLE, q + delta[0]), at(_AC_TABLE, q)),
                   (at(_DC_TABLE, q + delta[1]) * 2,
                    max(8, at(_AC_TABLE, q + delta[2]) * 101581 >> 16)),
                   (at(_DC_TABLE, q + delta[3], 117),
                    at(_AC_TABLE, q + delta[4]))))
    br.value_bits(1)
    proba = [[[[0] * 11 for _ in range(3)] for _ in range(8)]
             for _ in range(4)]
    k = 0
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    proba[t][b][c][p] = (br.value_bits(8) if br.bit(
                        _COEFFS_UPDATE_PROBA[k]) else _COEFFS_PROBA0[k])
                    k += 1
    use_skip = br.value_bits(1)
    skip_p = br.value_bits(8) if use_skip else 0

    info = np.zeros((mb_h, mb_w, 20), np.uint8)
    coeffs = np.zeros((mb_h, mb_w, 25, 16), np.int16)
    intra_top = [_DC] * (4 * mb_w)
    nz_top = [[0] * 9 for _ in range(mb_w)]   # 4 Y, 2 U, 2 V, Y2
    for mb_y in range(mb_h):
        intra_left = [_DC] * 4
        nz_left = [0] * 9
        for mb_x in range(mb_w):
            top = intra_top[4 * mb_x:4 * mb_x + 4]
            segment = 0
            if update_map:
                segment = (br.bit(seg_proba[1]) if not br.bit(seg_proba[0])
                           else br.bit(seg_proba[2]) + 2)
            skip = br.bit(skip_p) if use_skip else 0
            i4x4 = 1 - br.bit(145)
            if not i4x4:
                ymode = ((_TM if br.bit(128) else _HE) if br.bit(156)
                         else (_VE if br.bit(163) else _DC))
                modes = [ymode] * 16
                top, intra_left = [ymode] * 4, [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    ymode = intra_left[y]
                    for x in range(4):
                        p = _BMODES_PROBA[(top[x] * 10 + ymode) * 9:][:9]
                        ymode = (
                            _DC if not br.bit(p[0]) else
                            _TM if not br.bit(p[1]) else
                            _VE if not br.bit(p[2]) else
                            ((_HE if not br.bit(p[4]) else
                              _RD if not br.bit(p[5]) else _VR)
                             if not br.bit(p[3]) else
                             (_LD if not br.bit(p[6]) else
                              _VL if not br.bit(p[7]) else
                              _HD if not br.bit(p[8]) else _HU)))
                        top[x] = ymode
                    modes += top
                    intra_left[y] = ymode
            intra_top[4 * mb_x:4 * mb_x + 4] = top
            uvmode = (_DC if not br.bit(142) else _VE if not br.bit(114)
                      else _TM if br.bit(183) else _HE)
            info[mb_y, mb_x] = [segment, skip, i4x4, uvmode, *modes]
        if br.eof:
            raise _Refused(15, mb_y)
        tokens = parts[mb_y & last]
        for mb_x in range(mb_w):
            mb = info[mb_y, mb_x]
            out = coeffs[mb_y, mb_x]
            q = dq[mb[0]]
            tnz = nz_top[mb_x]
            if mb[1]:
                tnz[:8] = nz_left[:8] = [0] * 8
                if not mb[2]:
                    tnz[8] = nz_left[8] = 0
            else:
                blocks = [[0] * 16 for _ in range(25)]
                if not mb[2]:
                    nz = _tokens(tokens, proba[1], tnz[8] + nz_left[8],
                                 q[1], 0, blocks[0])
                    tnz[8] = nz_left[8] = int(nz > 0)
                    for k, v in enumerate(_wht(blocks[0])):
                        blocks[1 + k][0] = v
                    first, ac = 1, proba[0]
                else:
                    first, ac = 0, proba[3]
                for y in range(4):
                    lnz = nz_left[y]
                    for x in range(4):
                        nz = _tokens(tokens, ac, lnz + tnz[x], q[0], first,
                                     blocks[1 + 4 * y + x])
                        lnz = tnz[x] = int(nz > first)
                    nz_left[y] = lnz
                for ch in (4, 6):
                    for y in range(2):
                        lnz = nz_left[ch + y]
                        for x in range(2):
                            nz = _tokens(tokens, proba[2],
                                         lnz + tnz[ch + x], q[2], 0,
                                         blocks[17 + (ch - 4) * 2 + 2 * y + x])
                            lnz = tnz[ch + x] = int(nz > 0)
                        nz_left[ch + y] = lnz
                out[:] = blocks
            if tokens.eof:
                raise _Refused(16, mb_x, mb_y)
    return info, coeffs
