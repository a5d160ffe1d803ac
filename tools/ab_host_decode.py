"""Host decode times of several trees of this repository on one machine.

    python3 tools/ab_host_decode.py OUT_JSON TREE [TREE ...]

Writes the inputs once, with this tree's writers: 8-bit RGB PNGs of a
160 x 160 and a 256 x 256 procedural face and of a 640 x 480 frame, rows
through the five filters in turn (as chip_smoke.py's `time_decodes` writes
them), and baseline JPEGs at quality 90 of the 160 x 160 face and of a
1920 x 1080 frame (this tree's encoder); and it takes this tree's WebP
fixtures of the 160 x 160 face and the 1024 x 1024 frame, lossless and
lossy (tests/fixtures/webp). Then, in rounds (the trees in order, then in
reverse, twice over), it times each tree's `image_io.decode_png`,
`jpeg.decode_jpeg`, `webp.decode_webp` and the WebP plain versions
(`decode_webp_plain`, the whole lossless decode in Python;
`vp8_coefficients_plain`, the lossy parse up to the coefficients) on them,
in a fresh process of the tree's own (its package, its host library built
at first use before the timing), as the median ms of repeated calls; a
tree without `data/webp.py` reads none (null). Every tree must decode
every file to the same pixels. Prints each reading and writes
{tree: {label: [ms a round]}} to OUT_JSON. Only the host CPU is used.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEBP = ("lossless_face_160x160.webp", "lossless_frame_1024x1024.webp",
        "lossy_face_q90_160x160.webp", "lossy_frame_q80_1024x1024.webp")
# (label, file, decoder, calls a reading)
CASES = (("png_160x160.png", "png_160x160.png", "png", 41),
         ("png_256x256.png", "png_256x256.png", "png", 21),
         ("png_640x480.png", "png_640x480.png", "png", 11),
         ("jpeg_160x160.jpg", "jpeg_160x160.jpg", "jpeg", 41),
         ("jpeg_1920x1080.jpg", "jpeg_1920x1080.jpg", "jpeg", 7),
         *((name, name, "webp", 41 if "160" in name else 7)
           for name in WEBP),
         *((f"{name} plain", name, "webp_plain", 3 if "160" in name else 1)
           for name in WEBP))

WORKER = """
import hashlib, json, statistics, sys, time
sys.path.insert(0, ".")
from hifidiff_tpu_torch.data.image_io import decode_png
from hifidiff_tpu_torch.data.jpeg import decode_jpeg
fns = {"png": decode_png, "jpeg": decode_jpeg}
try:
    from hifidiff_tpu_torch.data import webp
    fns["webp"] = webp.decode_webp
    fns["webp_plain"] = lambda d: (
        webp.decode_webp_plain(d).tobytes() if webp.parse(d).lossless
        else b"".join(a.tobytes() for a in webp.vp8_coefficients_plain(d)))
except ImportError:
    pass
out = {}
for label, name, kind, n in json.loads(sys.argv[2]):
    if kind not in fns:
        out[label] = None
        continue
    data = open(sys.argv[1] + "/" + name, "rb").read()
    fn = fns[kind]
    got = fn(data)
    digest = hashlib.sha256(got if isinstance(got, bytes)
                            else got.tobytes()).hexdigest()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(data)
        times.append((time.perf_counter() - t0) * 1e3)
    out[label] = [statistics.median(times), digest]
print(json.dumps(out))
"""


def write_inputs(root):
    sys.path.insert(0, REPO)
    from hifidiff_tpu_torch.data import procedural as proc
    from hifidiff_tpu_torch.data.image_files import png_filtered
    from hifidiff_tpu_torch.data.jpeg import encode_jpeg

    idp = proc._identity_params(0, 0)

    def face(side):
        return (proc.render_face(idp, 0.3, side) * 255).astype(np.uint8)

    frame = np.ascontiguousarray(face(640)[80:560])
    big = proc.render_face(idp, 0.3, 640)
    big = (np.tile(big, (2, 3, 1))[:1080, :1920] * 255).astype(np.uint8)
    files = {"png_160x160.png": png_filtered(face(160)),
             "png_256x256.png": png_filtered(face(256)),
             "png_640x480.png": png_filtered(frame),
             "jpeg_160x160.jpg": encode_jpeg(face(160), 90),
             "jpeg_1920x1080.jpg": encode_jpeg(np.ascontiguousarray(big), 90)}
    for name in WEBP:
        with open(os.path.join(REPO, "tests", "fixtures", "webp", name),
                  "rb") as f:
            files[name] = f.read()
    for name, data in files.items():
        with open(os.path.join(root, name), "wb") as f:
            f.write(data)


def reading(tree, root):
    res = subprocess.run([sys.executable, "-c", WORKER, root,
                          json.dumps(CASES)], cwd=tree, capture_output=True,
                         text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"{tree}: {res.stderr[-2000:]}")
    return json.loads(res.stdout.splitlines()[-1])


def main(argv):
    out_path, trees = argv[0], [os.path.abspath(t) for t in argv[1:]]
    with tempfile.TemporaryDirectory() as root:
        write_inputs(root)
        for tree in trees:   # builds each tree's host library, untimed
            reading(tree, root)
        times = {t: {label: [] for label, *_ in CASES} for t in trees}
        digests = {}
        for order in (trees, trees[::-1], trees, trees[::-1]):
            for tree in order:
                for label, got in reading(tree, root).items():
                    if got is None:
                        times[tree][label] = None
                        continue
                    ms, digest = got
                    times[tree][label].append(ms)
                    if digests.setdefault(label, digest) != digest:
                        raise SystemExit(f"{tree} decodes {label} to other "
                                         "pixels than the first tree")
                    print(f"{os.path.basename(tree)} {label}: {ms:.3f} ms",
                          flush=True)
    with open(out_path, "w") as f:
        json.dump(times, f, indent=1)
    for label, *_ in CASES:
        print(label, "median of the rounds:", "  ".join(
            f"{os.path.basename(t)} " + (
                "-" if times[t][label] is None
                else f"{statistics.median(times[t][label]):.3f}")
            for t in trees), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
