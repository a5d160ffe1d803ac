"""The port's JPEG codec: `decode_jpeg` and `encode_jpeg`, bound to the
host library built from `csrc/host/jpeg.cc` (`data/host.py`).

`decode_jpeg` gives what libjpeg-turbo gives at its defaults, bit for bit,
as RGB: what PIL's `Image.open(f).convert("RGB")` and cv2's
`imdecode(buf, IMREAD_COLOR)` (flipped to RGB) read. Baseline,
extended-sequential and progressive 8-bit Huffman files of one, three or
four components, every sampling up to 2x2 (4:4:4, 4:2:2, 4:4:0, 4:2:0)
and whole ratios past it, grey (repeated over three channels), restart
intervals and any size. EXIF orientation is ignored, as `Image.open`
ignores it. A progressive file whose scans leave some of a component's
first nine AC coefficients short of bit 0 is refused: libjpeg smooths such
coefficients (`do_block_smoothing`) and its output is not theirs.
Lossless, hierarchical and arithmetic-coded files (SOF10, the
arithmetic-coded progressive, among them), 12-bit samples and truncated
data raise `JPEGError` naming what they are.

The colour space is libjpeg-turbo's default (`jdapimin.c`): three
components are YCbCr, or RGB (copied) where an Adobe APP14 marker says
transform 0 and no JFIF marker is there, or where neither marker is there
and the component ids are 'R', 'G', 'B' (PIL's `keep_rgb=True` writes the
first; both libraries read such a file alike); four components are CMYK,
or YCCK where an Adobe marker names another transform than 0, and libjpeg
turns YCCK into CMYK (`ycck_cmyk_convert`). The two libraries turn
libjpeg's CMYK into RGB differently (up to 2 levels apart), so a
four-component file needs `reader`, as a 16-bit PNG does: "pil" inverts
each sample (the "CMYK;I" raw mode, whatever the markers say) and then
takes `cmyk2rgb` of Pillow's Convert.c, nk - nk * c / 255 (rounded as
MULDIV255) with nk = 255 - k; "cv2" takes `icvCvt_CMYK2BGR_8u_C4C3R`,
k - ((255 - c) * k >> 8), on libjpeg's samples. Both rules were measured
on all 65,536 (C, K) pairs (tests/test_torch_jpeg.py). Without a reader a
four-component file raises, naming both.

`components` gives the upsampled components before any colour step, with
the colour space's name; `ycck_to_cmyk` and `cmyk_to_rgb` are the two
colour steps of the library alone, and `ycck_to_cmyk_plain` and
`cmyk_to_rgb_plain` their numpy versions.

`coefficients` gives the quantized DCT coefficients the decoder's scans
leave, with each component's latched quantization table, and
`coefficients_plain` computes them in Python: the entropy decoding (the
sequential scans, and the progressive DC / AC first and refine scans with
their EOB runs) held bit for bit to the library's. Only tests and
chip_smoke.py call them; the IDCT, upsampling and colour conversion after
them are held to libjpeg-turbo through cv2 and PIL.

`encode_jpeg` gives the bytes of `cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, q])` for the same pixels (cv2 takes them as BGR):
4:2:0, the Annex K tables scaled to `q`, the standard Huffman tables, a
JFIF header.
"""

from __future__ import annotations

import ctypes

import numpy as np

from hifidiff_tpu_torch.data import host

JPEG_SIGNATURE = b"\xff\xd8"
READERS = ("pil", "cv2")   # the libraries whose CMYK -> RGB decode_jpeg takes
SPACES = ("grey", "ycbcr", "rgb", "cmyk", "ycck")   # jpeg.cc's order


class JPEGError(ValueError):
    """A file the decoder cannot read, or an image the encoder cannot
    write, with the reason."""


def _take(lib, ptr: int, nbytes: int) -> bytes:
    try:
        return ctypes.string_at(ptr, nbytes)
    finally:
        lib.hj_free(ptr)


def _reader(reader) -> int:
    if reader not in (None, *READERS):
        raise ValueError(f"reader must be one of {READERS}, got {reader!r}")
    return 0 if reader is None else 1 + READERS.index(reader)


def decode_jpeg(data: bytes, reader=None) -> np.ndarray:
    """A JPEG file's bytes as an (H, W, 3) uint8 RGB array; a CMYK or YCCK
    file as `reader` ("pil" or "cv2") turns it into RGB, and without one
    it raises."""
    code = _reader(reader)
    lib = host.library()
    data = bytes(data)
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    ptr = lib.hj_decode(data, len(data), code, ctypes.byref(h),
                        ctypes.byref(w), err, len(err))
    if not ptr:
        raise JPEGError(err.value.decode())
    raw = _take(lib, ptr, h.value * w.value * 3)
    return np.frombuffer(raw, np.uint8).reshape(h.value, w.value, 3).copy()


def components(data: bytes):
    """(the upsampled components as (H, W, n) uint8, the colour space's
    name in SPACES): what the library decodes before any colour step."""
    lib = host.library()
    data = bytes(data)
    h, w, nc, space = (ctypes.c_int() for _ in range(4))
    err = ctypes.create_string_buffer(256)
    ptr = lib.hj_components(data, len(data), ctypes.byref(h),
                            ctypes.byref(w), ctypes.byref(nc),
                            ctypes.byref(space), err, len(err))
    if not ptr:
        raise JPEGError(err.value.decode())
    raw = _take(lib, ptr, h.value * w.value * nc.value)
    px = np.frombuffer(raw, np.uint8).reshape(h.value, w.value, nc.value)
    return px.copy(), SPACES[space.value]


def _pixels(px: np.ndarray, channels: int) -> np.ndarray:
    px = np.ascontiguousarray(px, np.uint8)
    if px.shape[-1:] != (channels,):
        raise ValueError(f"{channels} channels a pixel, got {px.shape}")
    return px


def ycck_to_cmyk(px: np.ndarray) -> np.ndarray:
    """The library's YCCK -> CMYK on (..., 4) uint8 pixels."""
    px = _pixels(px, 4)
    out = np.empty_like(px)
    host.library().hj_ycck_cmyk(px.ctypes.data, px.size // 4,
                                out.ctypes.data)
    return out


def cmyk_to_rgb(px: np.ndarray, reader: str) -> np.ndarray:
    """The library's CMYK -> RGB on (..., 4) uint8 pixels, as `reader`
    converts libjpeg's CMYK."""
    code = _reader(reader)
    if not code:
        raise ValueError(f"cmyk_to_rgb needs a reader, one of {READERS}")
    px = _pixels(px, 4)
    out = np.empty(px.shape[:-1] + (3,), np.uint8)
    host.library().hj_cmyk_rgb(px.ctypes.data, px.size // 4, code,
                               out.ctypes.data)
    return out


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table: Cr -> R, Cb -> B, and the two
    16-bit fixed-point terms of G (ONE_HALF in Cb's)."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = [int(v * 65536 + 0.5) for v in (1.40200, 1.77200, 0.71414, 0.34414)]
    return ((fix[0] * x + 32768) >> 16, (fix[1] * x + 32768) >> 16,
            -fix[2] * x, -fix[3] * x + 32768)


def ycck_to_cmyk_plain(px: np.ndarray) -> np.ndarray:
    """`ycck_to_cmyk` in numpy: its plain version."""
    px = _pixels(px, 4).astype(np.int64)
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    y, cb, cr = px[..., 0], px[..., 1], px[..., 2]
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], -1)
    return np.concatenate([np.clip(255 - rgb, 0, 255), px[..., 3:]],
                          -1).astype(np.uint8)


def cmyk_to_rgb_plain(px: np.ndarray, reader: str) -> np.ndarray:
    """`cmyk_to_rgb` in numpy: its plain version."""
    if not _reader(reader):
        raise ValueError(f"cmyk_to_rgb_plain needs a reader, one of {READERS}")
    px = _pixels(px, 4).astype(np.int64)
    c, k = px[..., :3], px[..., 3:]
    if reader == "pil":
        t = (255 - c) * k + 128
        out = k - (((t >> 8) + t) >> 8)
    else:
        out = k - (((255 - c) * k) >> 8)
    return out.astype(np.uint8)


def encode_jpeg(img: np.ndarray, quality: int) -> bytes:
    """An (H, W, 3) uint8 RGB image as JPEG bytes at `quality` (1-100)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise JPEGError(f"encode_jpeg takes (H, W, 3) uint8, got "
                        f"{img.shape} {img.dtype}")
    img = np.ascontiguousarray(img)
    lib = host.library()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    ptr = lib.hj_encode(img.ctypes.data, img.shape[0], img.shape[1],
                        int(quality), ctypes.byref(size), err, len(err))
    if not ptr:
        raise JPEGError(err.value.decode())
    return _take(lib, ptr, size.value)


def coefficients(data: bytes):
    """The decoder's coefficients through the host library: a list of one
    dict a component, {"h", "v", "quant" (64 int32, natural order),
    "coef" ((bh, bw, 64) int16, natural order)}, the blocks of the MCU
    grid, padding blocks included."""
    lib = host.library()
    data = bytes(data)
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    ptr = lib.hj_coefficients(data, len(data), ctypes.byref(size), err,
                              len(err))
    if not ptr:
        raise JPEGError(err.value.decode())
    raw = _take(lib, ptr, size.value)
    n = int(np.frombuffer(raw, np.int32, 1)[0])
    head = np.frombuffer(raw, np.int32, 1 + 68 * n).reshape(-1)[1:].reshape(
        n, 68)
    out, at = [], (1 + 68 * n) * 4
    for h, v, bw, bh, *quant in head.tolist():
        coef = np.frombuffer(raw, np.int16, bh * bw * 64, at)
        at += coef.nbytes
        out.append(dict(h=h, v=v, quant=np.array(quant, np.int32),
                        coef=coef.reshape(bh, bw, 64).copy()))
    return out


# -- the plain version of the entropy decoding -------------------------------

_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
           45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16
_NAMED = {0xC3: "lossless JPEG (SOF3) is not supported",
          0xC7: "lossless JPEG (SOF7) is not supported",
          0xC5: "hierarchical JPEG (SOF5) is not supported",
          0xC6: "hierarchical JPEG (SOF6, differential progressive) is not "
                "supported",
          0xCA: "arithmetic-coded JPEG (SOF10, progressive) is not "
                "supported"}
for _m in (0xC9, 0xCB, 0xCD, 0xCE, 0xCF, 0xCC):
    _NAMED[_m] = "arithmetic-coded JPEG is not supported"
_TRUNCATED = "truncated data: the entropy-coded data ends early"


def _huffman_lut(bits, vals):
    """Every 16-bit window's (code length << 8) | value, 0 where no code
    of the table starts it."""
    lut = np.zeros(1 << 16, np.int32)
    code, i = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            span = 1 << (16 - length)
            lut[code * span:(code + 1) * span] = (length << 8) | vals[i]
            code += 1
            i += 1
        if code > (1 << length):
            raise JPEGError("corrupt data: bad Huffman table")
        code <<= 1
    return lut.tolist()


class _Bits:
    """The entropy-coded segment from `pos` to the next marker (0xFF not
    followed by 0x00), its stuffed zeros dropped, read MSB first; zeros past
    its end, and `end` where the next marker starts."""

    def __init__(self, data, pos):
        end = pos
        while True:
            end = data.find(b"\xff", end)
            if end < 0:
                end = len(data)
                break
            if end + 1 >= len(data) or data[end + 1] != 0:
                break
            end += 2
        self.end = end
        seg = data[pos:end].replace(b"\xff\x00", b"\xff")
        self.nbits = 8 * len(seg)
        b = np.frombuffer(seg + bytes(4096), np.uint8).astype(np.uint32)
        self.win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8)
                    | b[3:]).tolist()
        self.pos = 0

    def get(self, n):
        p = self.pos
        self.pos = p + n
        if n == 0:
            return 0
        try:
            return (self.win[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)
        except IndexError:
            raise JPEGError(_TRUNCATED) from None

    def decode(self, lut):
        p = self.pos
        try:
            e = lut[(self.win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        except IndexError:
            raise JPEGError(_TRUNCATED) from None
        if not e:
            raise JPEGError("corrupt data: a Huffman code no table defines")
        self.pos = p + (e >> 8)
        return e & 0xFF

    def finish(self):
        if self.pos > self.nbits:
            raise JPEGError(_TRUNCATED)


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _i16(v):
    return ((v + 32768) & 0xFFFF) - 32768


def coefficients_plain(data: bytes):
    """`coefficients` in Python: its plain version."""
    data = bytes(data)
    if len(data) < 2 or data[:2] != b"\xff\xd8":
        raise JPEGError("not a JPEG file (no SOI marker)")
    st = dict(pos=2, frame=False, progressive=False, restart=0, scans=0)
    qt, dc_luts, ac_luts, comps = {}, {}, {}, []

    def u8():
        if st["pos"] >= len(data):
            raise JPEGError("truncated data: the file ends in a header")
        st["pos"] += 1
        return data[st["pos"] - 1]

    def u16():
        return (u8() << 8) | u8()

    def next_marker():
        pos = st["pos"]
        while True:
            pos = data.find(b"\xff", pos)
            if pos < 0:
                st["pos"] = len(data)
                return -1
            while pos < len(data) and data[pos] == 0xFF:
                pos += 1
            if pos >= len(data):
                st["pos"] = pos
                return -1
            m = data[pos]
            pos += 1
            if m:
                st["pos"] = pos
                return m

    def segment():
        n = u16() - 2
        if n < 0 or st["pos"] + n > len(data):
            raise JPEGError("truncated data: the file ends in a header")
        st["pos"] += n
        return data[st["pos"] - n:st["pos"]]

    def read_sof(progressive):
        if st["frame"]:
            raise JPEGError("corrupt data: a second frame header")
        st["progressive"] = progressive
        u16()
        precision = u8()
        if precision != 8:
            raise JPEGError(f"{precision}-bit samples are not supported "
                            "(8-bit only)")
        height, width, nc = u16(), u16(), u8()
        if height == 0:
            raise JPEGError("a zero or DNL-defined height is not supported")
        if width == 0:
            raise JPEGError("corrupt data: zero width")
        if nc not in (1, 3, 4):
            raise JPEGError(f"{nc}-component JPEG is not supported")
        for _ in range(nc):
            cid, hv, tq = u8(), u8(), u8()
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4 and tq <= 3):
                raise JPEGError("corrupt data: bad component parameters")
            comps.append(dict(id=cid, h=h, v=v, tq=tq, quant=None,
                              bits=[-1] * 64, dc=0, dc_tbl=0, ac_tbl=0))
        hmax = max(c["h"] for c in comps)
        vmax = max(c["v"] for c in comps)
        st.update(mcux=-(-width // (8 * hmax)), mcuy=-(-height // (8 * vmax)))
        for c in comps:
            if hmax % c["h"] or vmax % c["v"]:
                raise JPEGError("sampling factors that are not whole ratios "
                                "are not supported")
            c["wib"] = -(-width * c["h"] // (8 * hmax))
            c["hib"] = -(-height * c["v"] // (8 * vmax))
            c["bw"], c["bh"] = st["mcux"] * c["h"], st["mcuy"] * c["v"]
            c["coef"] = [[0] * 64 for _ in range(c["bw"] * c["bh"])]
        st["frame"] = True

    def read_dqt():
        n = u16() - 2
        while n > 0:
            pq_tq = u8()
            pq, tq = pq_tq >> 4, pq_tq & 15
            if tq > 3:
                raise JPEGError("corrupt data: DQT table index > 3")
            table = [0] * 64
            for i in range(64):
                table[_ZIGZAG[i]] = u16() if pq else u8()
            qt[tq] = table
            n -= 1 + 64 * (2 if pq else 1)
        if n != 0:
            raise JPEGError("corrupt data: bad DQT length")

    def read_dht():
        n = u16() - 2
        while n > 16:
            tc_th = u8()
            tc, th = tc_th >> 4, tc_th & 15
            if tc > 1 or th > 3:
                raise JPEGError("corrupt data: bad DHT index")
            bits = [0] + [u8() for _ in range(16)]
            count = sum(bits)
            if count > 256 or count > n - 17:
                raise JPEGError("corrupt data: bad DHT length")
            vals = [u8() for _ in range(count)]
            (ac_luts if tc else dc_luts)[th] = _huffman_lut(bits, vals)
            n -= 17 + count
        if n != 0:
            raise JPEGError("corrupt data: bad DHT length")

    def read_sos():
        if not st["frame"]:
            raise JPEGError("corrupt data: a scan before the frame header")
        u16()
        ns = u8()
        if not 1 <= ns <= min(4, len(comps)):
            raise JPEGError("corrupt data: bad scan component count")
        sc = []
        for _ in range(ns):
            cid, t = u8(), u8()
            found = [c for c in comps if c["id"] == cid]
            if not found:
                raise JPEGError("corrupt data: a scan names no component")
            c = found[-1]
            c["dc_tbl"], c["ac_tbl"] = t >> 4, t & 15
            if c["dc_tbl"] > 3 or c["ac_tbl"] > 3:
                raise JPEGError("corrupt data: a scan uses an undefined "
                                "Huffman table")
            if c["quant"] is None:
                if c["tq"] not in qt:
                    raise JPEGError("corrupt data: a component's "
                                    "quantization table is not defined")
                c["quant"] = list(qt[c["tq"]])
            sc.append(c)
        ss, se, ahal = u8(), u8(), u8()
        ah, al = ahal >> 4, ahal & 15
        prog = st["progressive"]
        if not prog:
            if (ss, se, ah, al) != (0, 63, 0, 0):
                raise JPEGError("corrupt data: a sequential scan with "
                                "spectral selection or approximation")
        elif (ss == 0 and se != 0) or (ss != 0 and (
                ss > se or se > 63 or ns != 1)) or (ah and al != ah - 1) \
                or al > 13:
            raise JPEGError(f"corrupt data: bad progressive scan parameters "
                            f"Ss={ss} Se={se} Ah={ah} Al={al}")
        for c in sc:
            if ((not prog or (ss == 0 and ah == 0))
                    and c["dc_tbl"] not in dc_luts) or \
                    ((not prog or ss != 0) and c["ac_tbl"] not in ac_luts):
                raise JPEGError("corrupt data: a scan uses an undefined "
                                "Huffman table")
            if prog:
                c["bits"][ss:se + 1] = [al] * (se - ss + 1)
        _scan(sc, ss, se, ah, al, prog)
        st["scans"] += 1

    def _scan(sc, ss, se, ah, al, prog):
        for c in sc:
            c["dc"] = 0
        run = [0]                # the EOB run
        br = _Bits(data, st["pos"])
        p1 = 1 << al

        def dc_first(c, blk):
            s = br.decode(dc_luts[c["dc_tbl"]])
            if s > 16:
                raise JPEGError("corrupt data: bad DC magnitude")
            c["dc"] += _extend(br.get(s), s) if s else 0
            blk[0] = _i16(c["dc"] << al)

        def dc_refine(c, blk):
            if br.get(1):
                blk[0] = _i16(blk[0] | p1)

        def sequential(c, blk):
            dc_first(c, blk)
            lut = ac_luts[c["ac_tbl"]]
            k = 1
            while k < 64:
                rs = br.decode(lut)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    blk[_ZIGZAG[k]] = _i16(_extend(br.get(s), s))
                elif r == 15:
                    k += 15
                else:
                    break
                k += 1

        def ac_first(c, blk):
            if run[0] > 0:
                run[0] -= 1
                return
            lut = ac_luts[c["ac_tbl"]]
            k = ss
            while k <= se:
                rs = br.decode(lut)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    blk[_ZIGZAG[k]] = _i16(_extend(br.get(s), s) << al)
                elif r == 15:
                    k += 15
                else:
                    run[0] = (1 << r) + (br.get(r) if r else 0) - 1
                    break
                k += 1

        def correct(blk, z):
            t = blk[z]
            if br.get(1) and not t & p1:
                blk[z] = _i16(t + p1 if t >= 0 else t - p1)

        def ac_refine(c, blk):
            k = ss
            if run[0] == 0:
                lut = ac_luts[c["ac_tbl"]]
                while k <= se:
                    rs = br.decode(lut)
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if br.get(1) else -p1
                    elif r != 15:
                        run[0] = (1 << r) + (br.get(r) if r else 0)
                        break
                    while True:
                        z = _ZIGZAG[k]
                        if blk[z]:
                            correct(blk, z)
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                        if k > se:
                            break
                    if s:
                        blk[_ZIGZAG[k]] = s
                    k += 1
            if run[0] > 0:
                while k <= se:
                    z = _ZIGZAG[k]
                    if blk[z]:
                        correct(blk, z)
                    k += 1
                run[0] -= 1

        if not prog:
            decode = sequential
        elif ss == 0:
            decode = dc_refine if ah else dc_first
        else:
            decode = ac_refine if ah else ac_first
        if len(sc) == 1:
            c = sc[0]
            units = [[(c, by * c["bw"] + bx)] for by in range(c["hib"])
                     for bx in range(c["wib"])]
        else:
            if sum(c["h"] * c["v"] for c in sc) > 10:
                raise JPEGError("corrupt data: more than 10 blocks in an MCU")
            units = [[(c, (my * c["v"] + y) * c["bw"] + mx * c["h"] + x)
                      for c in sc for y in range(c["v"])
                      for x in range(c["h"])]
                     for my in range(st["mcuy"]) for mx in range(st["mcux"])]
        todo, next_rst = st["restart"], 0
        for unit in units:
            if st["restart"] and todo == 0:
                br.finish()
                st["pos"] = br.end
                m = next_marker()
                if m == -1:
                    raise JPEGError("truncated data: the file ends in a scan")
                if m != 0xD0 + next_rst:
                    raise JPEGError(f"corrupt data: restart marker "
                                    f"RST{next_rst} expected")
                next_rst = (next_rst + 1) & 7
                for c in sc:
                    c["dc"] = 0
                run[0] = 0
                br = _Bits(data, st["pos"])
                todo = st["restart"]
            for c, b in unit:
                decode(c, c["coef"][b])
            todo -= 1
        br.finish()
        st["pos"] = br.end

    while True:
        m = next_marker()
        if m == -1:
            raise JPEGError("truncated data: the file ends before its EOI "
                            "marker")
        if m == 0xD9:
            break
        if m in (0xC0, 0xC1, 0xC2):
            read_sof(m == 0xC2)
        elif m in _NAMED:
            raise JPEGError(_NAMED[m])
        elif m == 0xC4:
            read_dht()
        elif m == 0xDB:
            read_dqt()
        elif m == 0xDD:
            u16()
            st["restart"] = u16()
        elif m == 0xDA:
            read_sos()
        elif m == 0xD8:
            raise JPEGError("corrupt data: a second SOI marker")
        elif 0xD0 <= m <= 0xD7:
            pass
        else:
            segment()
    _check_frame(st, comps)
    return [dict(h=c["h"], v=c["v"], quant=np.array(c["quant"], np.int32),
                 coef=np.array(c["coef"], np.int16).reshape(c["bh"], c["bw"],
                                                           64))
            for c in comps]


def _check_frame(st, comps):
    """The end-of-file refusals of `Decoder::parse` in csrc/host/jpeg.cc."""
    if not st["frame"]:
        raise JPEGError("corrupt data: no frame header")
    if not st["scans"]:
        raise JPEGError("corrupt data: no scan")
    if any(c["quant"] is None for c in comps):
        raise JPEGError("truncated data: a component no scan holds")
    if st["progressive"] and all(
            c["bits"][0] >= 0 and all(c["quant"][p] for p in (
                0, 1, 8, 16, 9, 2, 3, 10, 17, 24)) for c in comps) and any(
            b != 0 for c in comps for b in c["bits"][1:10]):
        raise JPEGError("incomplete progressive JPEG: libjpeg would smooth "
                        "it (the first AC coefficients are not all refined "
                        "to bit 0)")
