"""The port's batching server (`hifidiff_tpu_torch/cli/serve.py`) on the CPU,
tiny stack, 2 DDIM steps, float32: every case of tests/test_serve.py on the
port's server, PNG bodies decoded without PIL (Adam7 and 16-bit ones as
the JAX handler's PIL decodes them, a JPEG sent as image/png too; a body
the decoder refuses answered 400), the runner against the JAX server's
split sampler on the same weights and normals (uint8 faces within 1 level),
and the runner's seeded launches.

On the card (`cuda`-marked, skipped elsewhere; no jax is imported then:
`python -m pytest --noconftest -m cuda tests/test_torch_serve.py`): each
bucket's graphs are captured on the caller's thread and replayed from the
batcher's worker thread, and the faces equal an eager call's bit for bit; a
launch that no longer replays fails.
"""

import copy
import dataclasses
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hifidiff_tpu_torch.cli.common import seeded_generator
from hifidiff_tpu_torch.cli.serve import (Config, _Batcher, build_runner,
                                          create_server)
from torch_parity import TINY_CLI, write_tiny_checkpoints

torch.set_num_threads(1)
SIZE = TINY_CLI["size"]
TINY = dict(TINY_CLI, num_inference_steps=2, dtype="f32", device="cpu")
HEALTHZ_KEYS = {"status", "batch", "buckets", "steps", "cache_interval",
                "sampler", "served", "batches", "mean_fill"}
# the port's uint8 faces against the JAX server's: one rounding boundary
FACE_LEVEL_TOL = 1


@pytest.fixture(scope="module")
def server():
    cfg = Config(port=0, batch=4, max_wait_ms=200.0, **TINY)
    httpd, batcher = create_server(cfg)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    yield base, batcher
    httpd.shutdown()
    httpd.server_close()
    batcher.stop()


def _post(base, body, ctype="application/octet-stream"):
    req = urllib.request.Request(base + "/infer", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (SIZE, SIZE, 3), np.uint8)
            for _ in range(n)]


def _spy_sampler(run, monkeypatch):
    """Record (launch counter, batch shape) of each call of the runner's
    sampler; returns the list it fills."""
    launched, sampler = [], run.sampler

    def spy(x, *a):
        launched.append((run.counter, tuple(x.shape)))
        return sampler(x, *a)

    spy.replays = sampler.replays
    monkeypatch.setattr(run, "sampler", spy)
    return launched


def test_concurrent_requests_batched_and_valid(server):
    base, batcher = server
    imgs = _images(3)
    results = [None] * 3

    def call(i):
        results[i] = _post(base, imgs[i].tobytes())

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    batches_before = batcher.batches
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    outs = []
    for status, body in results:
        assert status == 200
        assert len(body) == SIZE * SIZE * 3
        outs.append(np.frombuffer(body, np.uint8).reshape(SIZE, SIZE, 3))
    # distinct inputs -> distinct restored outputs (the sampler ran, not an
    # echo), and one window packs the three into at most two launches
    assert not np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], imgs[0])
    assert batcher.batches - batches_before <= 2


def test_healthz(server):
    base, batcher = server
    _post(base, _images(1, seed=5)[0].tobytes())
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        stats = json.loads(r.read())
    assert set(stats) == HEALTHZ_KEYS
    assert stats["status"] == "ok"
    assert stats["batch"] == 4 and stats["buckets"] == [4]
    assert stats["steps"] == 2 and stats["sampler"] == "ddim"
    assert stats["served"] >= 1 and stats["batches"] >= 1


def test_wrong_size_rejected(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(base, b"\x00" * 17)
    assert exc.value.code == 400


def test_unknown_path(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert exc.value.code == 404
    req = urllib.request.Request(base + "/nope", data=b"x")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 404


def test_png_round_trip(server):
    Image = pytest.importorskip("PIL.Image")
    base, _ = server
    buf = io.BytesIO()
    Image.fromarray(_images(1, seed=1)[0]).save(buf, format="PNG")
    status, body = _post(base, buf.getvalue(), "image/png")
    assert status == 200
    assert Image.open(io.BytesIO(body)).size == (SIZE, SIZE)


def test_png_without_pil_is_served(server, monkeypatch):
    """With PIL blocked a PNG body is decoded by the port's own decoder and
    PIL-bicubic resized to the server's size (`data/image_io`,
    `data/resize`): 200, a PNG reply whose face equals the face a raw
    request of the same decoded, resized pixels gets (both launches drawn
    from the same generator)."""
    from hifidiff_tpu_torch.data.image_io import decode_png
    from hifidiff_tpu_torch.data.resize import resize_pil
    from hifidiff_tpu_torch.utils.logging import png_bytes

    base, batcher = server
    monkeypatch.setitem(sys.modules, "PIL", None)
    real = batcher.run_fn
    monkeypatch.setattr(batcher, "run_fn", lambda imgs: real(
        imgs, generator=seeded_generator(7, 0, "cpu")))
    rng = np.random.default_rng(11)
    png = png_bytes(rng.integers(0, 256, (SIZE + 9, SIZE - 3, 3), np.uint8))
    status, body = _post(base, png, "image/png")
    assert status == 200
    face = decode_png(body)
    pixels = resize_pil(decode_png(png), (SIZE, SIZE), "bicubic")
    status, raw = _post(base, pixels.tobytes())
    assert status == 200
    np.testing.assert_array_equal(
        face, np.frombuffer(raw, np.uint8).reshape(SIZE, SIZE, 3))


@pytest.mark.parametrize("kind", ["adam7 16-bit grey", "adam7 16-bit RGB",
                                  "progressive JPEG as image/png",
                                  "lossy WebP as image/png",
                                  "lossless WebP as image/png",
                                  "CMYK JPEG as image/png",
                                  "animated WebP as image/png"])
def test_new_formats_decoded_as_the_jax_handler(server, monkeypatch, kind):
    """An Adam7 16-bit grey PNG body, an Adam7 16-bit colour one, a
    progressive JPEG, a lossy and a lossless WebP (which the port's
    server answered 400 before it read WebP), a CMYK JPEG and an animated
    WebP (400 before it read those) sent as image/png: with PIL blocked,
    200, and the face
    a raw request of the JAX handler's pixels gets (its PIL
    `convert("RGB")` and bicubic resize, taken before PIL is blocked; both
    launches drawn from the same generator). PIL clamps 16-bit grey to 255
    where cv2 keeps the high byte: the server reads as PIL does."""
    Image = pytest.importorskip("PIL.Image")
    from hifidiff_tpu_torch.data.image_files import png_file

    rng = np.random.default_rng(12)
    ch = 1 if "grey" in kind else 3
    wide = rng.integers(0, 1 << 16, (SIZE + 7, SIZE - 5, ch))
    if "JPEG" in kind or "WebP" in kind:
        buf = io.BytesIO()
        opts = (dict(format="JPEG", quality=90, progressive="CMYK" not in kind)
                if "JPEG" in kind else
                dict(format="WEBP", quality=80, lossless="lossless" in kind))
        img = (wide >> 8).astype(np.uint8)
        if "CMYK" in kind:
            img = Image.fromarray(np.concatenate([img, img[..., 1:2]], -1),
                                  "CMYK")
        else:
            img = Image.fromarray(img)
        if "animated" in kind:
            opts.update(save_all=True, append_images=[img.rotate(90)])
        img.save(buf, **opts)
        body = buf.getvalue()
    else:
        body = png_file(wide, 16, 0 if ch == 1 else 2, interlace=1)
    pixels = np.asarray(Image.open(io.BytesIO(body)).convert("RGB").resize(
        (SIZE, SIZE), Image.BICUBIC), np.uint8)
    base, batcher = server
    monkeypatch.setitem(sys.modules, "PIL", None)
    real = batcher.run_fn
    monkeypatch.setattr(batcher, "run_fn", lambda imgs: real(
        imgs, generator=seeded_generator(9, 0, "cpu")))
    status, served = _post(base, body, "image/png")
    assert status == 200
    status, raw = _post(base, pixels.tobytes())
    assert status == 200
    from hifidiff_tpu_torch.data.image_io import decode_png
    np.testing.assert_array_equal(
        decode_png(served), np.frombuffer(raw, np.uint8).reshape(SIZE, SIZE,
                                                                 3))


def test_png_the_decoder_refuses_is_bad_image(server):
    """A body the decoder cannot read (an interlaced PNG; a PNG signature
    and nothing else) is a client error, 400 "bad image" with the
    decoder's reason, and the server goes on answering."""
    import struct
    import zlib

    from hifidiff_tpu_torch.utils.logging import png_bytes

    base, _ = server
    png = png_bytes(_images(1)[0])
    header = png[16:28] + b"\x01"   # IHDR with the interlace flag set
    interlaced = (png[:16] + header
                  + struct.pack(">I", zlib.crc32(b"IHDR" + header))
                  + png[33:])
    for body, reason in ((interlaced, "interlaced"),
                         (b"\x89PNG\r\n\x1a\n", "IEND")):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base, body, "image/png")
        assert exc.value.code == 400
        error = json.loads(exc.value.read())["error"]
        assert "bad image" in error and reason in error, error
    status, _ = _post(base, _images(1)[0].tobytes())
    assert status == 200


def test_load_generator(server):
    """`serve_bench.run_load` against the server: one phase per concurrency,
    every request answered, the launches and fill read from /healthz."""
    from hifidiff_tpu_torch.cli import serve_bench

    base, _ = server
    host, port = base[len("http://"):].rsplit(":", 1)
    phases = serve_bench.run_load(host, int(port), SIZE, [1, 3], 2)
    assert [p["concurrency"] for p in phases] == [1, 3]
    for p in phases:
        assert p["errors"] == 0 and p["requests"] == 2 * p["concurrency"]
        assert p["p95_ms"] >= p["p50_ms"] > 0
        assert p["launches"] >= 1 and p["throughput_faces_per_sec"] > 0
        assert p["mean_fill"] * p["launches"] == p["requests"]


def test_stop_drains_pending_requests():
    """Requests still queued at shutdown fail fast instead of hanging their
    handler threads."""
    gate = threading.Event()

    def slow_run(imgs):
        gate.wait(10)  # hold the first batch until shutdown begins
        return imgs

    b = _Batcher(slow_run, batch=1, max_wait_s=0.01)
    b.start()
    results = [None] * 3

    def call(i):
        try:
            b.submit(np.zeros((2, 2, 3), np.uint8))
            results[i] = "ok"
        except RuntimeError:
            results[i] = "shutdown"

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    threads[0].start()
    time.sleep(0.3)   # the worker is inside slow_run: 1 and 2 must queue
    threads[1].start()
    threads[2].start()
    time.sleep(0.3)
    threading.Timer(0.3, gate.set).start()
    b.stop()  # joins the worker (released by the timer), then drains
    for t in threads:
        t.join(timeout=10)
    assert results[0] == "ok"
    assert results[1] == "shutdown" and results[2] == "shutdown"
    with pytest.raises(RuntimeError):
        b.submit(np.zeros((2, 2, 3), np.uint8))


def test_arrival_renewed_window_merges_stragglers():
    """Requests spaced within max_wait but together longer than it pack into
    one launch; the hard cap still bounds the wait."""
    launches = []

    def run(imgs):
        launches.append(len(imgs))
        return imgs

    b = _Batcher(run, batch=6, max_wait_s=0.08, max_fill_wait_s=2.0)
    b.start()
    try:
        results = []

        def call():
            results.append(b.submit(np.zeros((2, 2, 3), np.uint8)))

        threads = []
        for _ in range(6):
            t = threading.Thread(target=call)
            t.start()
            threads.append(t)
            time.sleep(0.03)
        for t in threads:
            t.join(timeout=10)
        assert len(results) == 6
        assert launches == [6]
        # the cap: a request after it cannot extend the window
        b2 = _Batcher(run, batch=6, max_wait_s=0.05, max_fill_wait_s=0.05)
        b2.start()
        try:
            t1 = threading.Thread(target=lambda: b2.submit(
                np.zeros((2, 2, 3), np.uint8)))
            t1.start()
            time.sleep(0.2)
            t2 = threading.Thread(target=lambda: b2.submit(
                np.zeros((2, 2, 3), np.uint8)))
            t2.start()
            t1.join(timeout=10)
            t2.join(timeout=10)
            assert b2.batches == 2 and b2.served == 2
        finally:
            b2.stop()
    finally:
        b.stop()


def test_bucketed_launches():
    """A lone request runs in the batch-1 bucket, a 3-burst in the batch-4
    one (or, if the burst raced the window, in smaller buckets)."""
    launches = []

    def run(imgs):
        launches.append(imgs.shape[0])
        return imgs

    b = _Batcher(run, batch=4, max_wait_s=0.15, buckets=[1, 2])
    assert b.buckets == [1, 2, 4]
    b.start()
    try:
        img = np.zeros((2, 2, 3), np.uint8)
        b.submit(img)
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            b.submit(img))) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(results) == 3
    finally:
        b.stop()
    assert launches[0] == 1
    assert all(n in (1, 2, 4) for n in launches)
    assert sum(launches) >= 4


@pytest.mark.parametrize("kw, match", [
    (dict(mesh_devices=2, device="cuda"), "has 1 CUDA card"),
    (dict(mesh_devices=-1), ">= 0"),
    (dict(dtype="fp16"), "dtype"),
])
def test_config_refusals(kw, match, monkeypatch):
    """More cards than the host has (here one, `torch.cuda` stubbed so that
    the count is read before any model is built) and a negative count are
    refused by name, where the JAX server takes the minimum; bf16 or f32
    only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=match):
        create_server(Config(port=0, **dict(TINY, **kw)))


def test_split_and_merge_over_two_devices():
    """`--mesh-devices` over ["cpu", "cpu"]: the batch and the buckets round
    up to the device multiple, each replica takes a contiguous half of a
    launch's rows with its half of the noise drawn for the whole batch, and
    the merged faces equal one device's launch on the same generator bit
    for bit."""
    from hifidiff_tpu_torch.cli.serve import Runner

    one = Runner(Config(batch=4, **TINY), devices=["cpu"])
    cfg = Config(batch=3, buckets="1", **TINY)
    two = Runner(cfg, devices=["cpu", "cpu"])
    assert cfg.batch == 4 and two.buckets == [2, 4]
    assert len(two.samplers) == 2 and two.samplers[0] is not two.samplers[1]
    imgs = np.stack(_images(4, seed=5))
    want = one(imgs, seeded_generator(0, 7, "cpu"))
    got = two(imgs, seeded_generator(0, 7, "cpu"))
    np.testing.assert_array_equal(got, want)
    # the halves came from different replicas, not from one device twice
    np.testing.assert_array_equal(two(imgs[:2], seeded_generator(0, 8,
                                                                "cpu")),
                                  one(imgs[:2], seeded_generator(0, 8,
                                                                "cpu")))


def test_runner_buckets_and_counter(monkeypatch):
    """Buckets are sorted, capped at the batch; the warm-up launches each
    bucket once and counts those launches, as the JAX server's does."""
    run, warmup, buckets = build_runner(Config(batch=4, buckets="8,1,2,0",
                                               **TINY))
    assert buckets == [1, 2, 4] and run.counter == 0
    launched = _spy_sampler(run, monkeypatch)
    warmup()
    assert run.counter == 3 and run.captured == {}
    assert launched == [(1, (1, SIZE, SIZE, 3)), (2, (2, SIZE, SIZE, 3)),
                        (3, (4, SIZE, SIZE, 3))]


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    cfg = Config(**TINY)
    paths, trees, _ = write_tiny_checkpoints(
        tmp_path_factory.mktemp("serve_ckpt"), cfg)
    cfg = dataclasses.replace(cfg, refiner_ckpt=paths["refiner"],
                              cr_ckpt=paths["cr"], vae_ckpt=paths["vae"])
    run, _, _ = build_runner(cfg)
    return cfg, trees, run


def _jax_normals(key, batch, latent):
    """The normals the JAX split sampler draws from `key`: (latents,
    posterior)."""
    import jax

    k_lat, k_enc = jax.random.split(key)
    shape = (batch, latent, latent, 4)
    return (np.array(jax.random.normal(k_lat, shape)),
            np.array(jax.random.normal(k_enc, shape, np.float32)))


def test_runner_matches_jax_serve(stack):
    """The JAX split sampler as the JAX server builds it (clip_sample, range
    3.0, uint8 I/O), called with fold_in(PRNGKey(seed), n), against the
    port's runner given the normals JAX draws from that key: uint8 faces
    within one level."""
    import jax

    from hifidiff_tpu.cli import common as jcommon
    from hifidiff_tpu.cli import serve as jserve
    from hifidiff_tpu.pipeline import (RefinerPipelineConfig,
                                       build_refiner_sampler_split)

    cfg, trees, run = stack
    jcfg = jserve.Config(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(jserve.Config)
                            if hasattr(cfg, f.name)
                            and f.name != "mesh_devices"},
                         platform="cpu", mesh_devices=1)
    cr, vae, refiner, schedule, latent = jcommon.build_refiner_models(jcfg)
    sampler = build_refiner_sampler_split(
        refiner, cr, vae, schedule,
        RefinerPipelineConfig(
            num_inference_steps=jcfg.num_inference_steps,
            latent_size=latent, sampler=jcfg.sampler,
            cache_interval=jcfg.cache_interval, io_uint8=True,
            clip_sample=True, clip_sample_range=jcfg.clip_sample_range))
    imgs = np.stack(_images(2, seed=3))
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 5)
    want = np.asarray(sampler({"refiner": trees["refiner"],
                               "cr": trees["cr"], "vae": trees["vae"]},
                              imgs, key))
    lat, post = _jax_normals(key, 2, latent)
    got = run(imgs, latents_noise=torch.from_numpy(lat),
              posterior_noise=torch.from_numpy(post))
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= FACE_LEVEL_TOL
    assert len(np.unique(got)) > 16   # not a flat image


def test_runner_seeded_launches(stack, monkeypatch):
    """Two launches at one (seed, counter) give equal bits, the next
    counter's launch differs, and a launch's noise is
    `seeded_generator(seed, counter)`'s."""
    _, _, run = stack
    imgs = np.stack(_images(2, seed=4))
    launched = _spy_sampler(run, monkeypatch)
    run.counter = 6
    first = run(imgs)
    assert run.counter == 7 and launched == [(7, (2, SIZE, SIZE, 3))]
    run.counter = 6
    assert np.array_equal(run(imgs), first)
    assert not np.array_equal(run(imgs), first)   # counter 8
    given = run(imgs, generator=seeded_generator(run.seed, 7, "cpu"))
    assert np.array_equal(given, first)


def test_runner_refuses_a_launch_that_did_not_replay(stack, monkeypatch):
    """Once the warm-up has captured graphs, a launch that ran eagerly
    raises (through the batcher: the request fails) instead of serving
    several times slower. The CPU sampler never replays, so an entry in
    `captured` stands in for the card's warm-up."""
    _, _, run = stack
    monkeypatch.setattr(run, "captured", {2: "captured"})
    imgs = _images(2, seed=5)
    with pytest.raises(RuntimeError, match="ran eagerly"):
        run(np.stack(imgs))
    batcher = _Batcher(run, 2, 0.01)
    batcher.start()
    try:
        with pytest.raises(RuntimeError, match="ran eagerly"):
            batcher.submit(imgs[0])
    finally:
        batcher.stop()


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the server captures CUDA graphs")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replay_from_the_batchers_thread_is_eager(cuda):
    """Graphs captured on this thread (the warm-up) and replayed from the
    batcher's worker thread give the eager call's bits, at bucket 1 (one
    request) and bucket 4 (three requests, padded); every launch replays.
    With the captures dropped, the next request fails."""
    from hifidiff_tpu_torch.pipeline import build_refiner_sampler_split
    from hifidiff_tpu_torch.random_weights import perturb_

    cfg = Config(batch=4, buckets="1", max_wait_ms=300.0,
                 **dict(TINY, num_inference_steps=3, dtype="bf16",
                        device="cuda"))
    run, warmup, buckets = build_runner(cfg)
    g = torch.Generator().manual_seed(0)
    for m in run.models:
        perturb_(m, g)
    warmup()
    assert buckets == [1, 4] and set(run.captured) == {1, 4}
    # over copies: `.to()` of the server's own models would renew the
    # blocks' pack generations and drop its captures
    eager = build_refiner_sampler_split(*copy.deepcopy(run.models),
                                        run.sampler.config, device=cuda)
    launched = []

    def recorded(imgs):
        launched.append((run.counter + 1, imgs))
        return run(imgs)

    batcher = _Batcher(recorded, 4, 0.3, buckets=buckets)
    batcher.start()
    try:
        for n_req, bucket in ((1, 1), (3, 4)):
            replays = run.sampler.replays
            imgs = _images(n_req, seed=n_req)
            outs = [None] * n_req

            def call(i, imgs=imgs, outs=outs):
                outs[i] = batcher.submit(imgs[i])

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(n_req)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            counter, batch = launched[-1]
            assert batch.shape[0] == bucket
            assert run.sampler.replays == replays + 1
            ref = eager(torch.from_numpy(batch).to(cuda),
                        generator=seeded_generator(cfg.seed, counter,
                                                   cuda)).cpu().numpy()
            for img, out in zip(imgs, outs):
                slot = next(j for j in range(bucket)
                            if np.array_equal(batch[j], img))
                assert np.array_equal(out, ref[slot])
            control = eager(torch.from_numpy(batch).to(cuda),
                            generator=seeded_generator(cfg.seed, counter + 1,
                                                       cuda)).cpu().numpy()
            assert not np.array_equal(control, ref)
        run.sampler.clear_compiled()
        with pytest.raises(RuntimeError, match="ran eagerly"):
            batcher.submit(_images(1, seed=9)[0])
    finally:
        batcher.stop()
