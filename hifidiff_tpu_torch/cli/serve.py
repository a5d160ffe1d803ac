"""Batching inference server over the split sampler, on one card
(counterpart of hifidiff_tpu/cli/serve.py).

The reference has no serving story (its inference is `test_refiner.py`'s
offline loop). This server puts `pipeline.build_refiner_sampler_split`
behind a dependency-free HTTP interface with dynamic batching:

  * requests queue up and are packed into a fixed launch batch (`--batch`,
    default 16, the JAX package's default) or into the smallest of the
    `--buckets` that holds them, padded by repeating the last real sample; a
    batch launches when full or when the window closes: each new arrival
    renews a `--max-wait-ms` window, up to `--max-fill-wait-ms` from the
    first request;
  * POST /infer with a raw uint8 RGB body (size*size*3 bytes,
    Content-Type: application/octet-stream) or a PNG (image/png, or a body
    with the PNG signature: decoded by `data/image_io.decode_image` as PIL
    decodes it, 16-bit samples and Adam7 too, and, as the JAX server's
    PIL, a JPEG, WebP or BMP body sent as image/png; PIL-bicubic resized to
    `--size` by `data/resize`; a body the decoder refuses gets 400 "bad
    image" with its reason) -> the
    restored face in the same format (the PNG written by
    `utils/logging.png_bytes`);
  * GET /healthz -> JSON {status, batch, buckets, steps, cache_interval,
    sampler, served, batches, mean_fill}.

Cold start (`build_runner`, then its `warmup`): the kernels are built from
`csrc/` (nvcc), the weights loaded, then each bucket's three stages are
captured as CUDA graphs (`RefinerSampler.warm_compile` on a zero batch of
that size) and each bucket is replayed once. From then on every launch is a
replay (the sampler's `replays` counter rises by one a launch): no eager
call and no capture while serving, the counterpart of the JAX server's zero
recompiles. A launch that ran eagerly instead (the captures were dropped:
the models were moved, cast or reloaded) raises, and its requests fail with
a 500, rather than serving several times slower. The device calls of the
warm-up run on the thread that calls `create_server`; every later one on
the batcher's single worker thread, one at a time. A graph captured on one
thread and replayed from another gives the eager call's bits
(`tests/test_torch_serve.py`, CUDA). On the CPU (`device="cpu"`, the tests)
there are no graphs and every launch is eager.

Noise: each launch draws its latents and posterior noise from a
`torch.Generator` on the card seeded from (seed, launch counter)
(`common.seeded_generator`), the counterpart of the JAX server's
`fold_in(key, counter)`. The counter counts the warm-up's launches too, as
the JAX server's does, so launch n of a server draws the same stream in
every run.

Data-parallel serving (`--mesh-devices`, the JAX server's meaning): 0 means
every local card, n means n cards; the launch batch and the buckets round up
to a multiple of the card count. Each card holds its own replica of the
models and its own captured graphs; a launch splits its rows into
contiguous slices, one a card, replays each card's graphs (they run at once,
the host only enqueues them) and concatenates the faces. The noise of a
launch is drawn for the whole batch on the first card, as one card would
draw it, and split with the rows, so that the faces do not depend on the
card count.

Differences from the JAX server's `Config`:
  * `platform` is `device`: "cuda" (the default; raises without a card) or
    "cpu";
  * `mesh_devices` beyond `torch.cuda.device_count()` raises, where the JAX
    server takes the minimum (it does so only for 0, every card); with
    `device="cpu"` n counts replicas on the CPU (tests);
  * `dtype` is "bf16" or "f32"; anything else raises.
There is no overlapped ahead-of-time compile: a CUDA graph captures real
tensors, so the capture follows the weights' load.

    python -m hifidiff_tpu_torch.cli.serve --refiner-ckpt refiner.pt \
        --cr-ckpt cr.pt --vae-ckpt vae.pt --port 8787
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import (load_refiner_stack, load_tiny_seams,
                                           model_dtype, parse_config,
                                           parse_ints, seeded_generator)
from hifidiff_tpu_torch.data.image_io import PNG_SIGNATURE, decode_image
from hifidiff_tpu_torch.data.resize import resize_pil
from hifidiff_tpu_torch.devices import resolve_device
from hifidiff_tpu_torch.ops import kernels
from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                         build_refiner_sampler_split)
from hifidiff_tpu_torch.utils.logging import png_bytes


@dataclasses.dataclass
class Config:
    host: str = "127.0.0.1"
    port: int = 8787            # 0 = ephemeral (tests)
    batch: int = 16             # the largest launch batch
    buckets: str = ""           # optional comma list of ADDITIONAL launch
    # batch sizes (e.g. "1,4"): a launch pads to the smallest bucket >= the
    # number of queued requests instead of always the full --batch; every
    # bucket is captured and replayed once at startup
    max_wait_ms: float = 30.0   # batching window, renewed by each arrival
    max_fill_wait_ms: float = 500.0  # ... up to this cap from the first
    # request: a padded partial launch costs the same device time as a full
    # one, so merging stragglers pays until the cap bounds the added latency
    mesh_devices: int = 0       # data-parallel cards: 0 = every local card
    # sampling mode
    num_inference_steps: int = 50
    cache_interval: int = 1
    sampler: str = "ddim"
    clip_sample_range: float = 3.0
    # checkpoint files (cli/common.py's formats; empty = random init +
    # warning)
    refiner_ckpt: str = ""
    cr_ckpt: str = ""
    vae_ckpt: str = ""
    tae_ckpt: str = ""          # the tiny autoencoder (enc. / dec. names)
    tae_mode: str = "both"      # "decode" or "both" (also tiny encode)
    tiny_cr_ckpt: str = ""      # the TinyCR at the CR seam
    tiny_cr_width: int = 64     # student arch (must match the ckpt)
    tiny_cr_blocks: int = 4
    tiny_cr_down: int = 2
    # model-size knobs (defaults = reference architecture)
    size: int = 128
    width: int = 128
    enc_depths: str = "2,2,4,8"
    mid_depth: int = 8
    dec_depths: str = "2,2,2,2"
    idc_stages: str = "3,4,6,3"
    cr_width: int = 32
    cr_enc_depths: str = "2,2,4,8"
    cr_mid_depth: int = 8
    vae_blocks: str = "128,256,512,512"
    vae_layers: int = 2
    seed: int = 0
    dtype: str = "bf16"         # weights and compute: "bf16" or "f32"
    device: str = "cuda"        # "cpu" only when asked for (tests)


class _Server(ThreadingHTTPServer):
    # a burst of N simultaneous client connects must not overflow the TCP
    # accept backlog (the default request_queue_size=5 drops connections at
    # concurrency 16/32)
    request_queue_size = 128


class _Batcher:
    """Packs queued requests into fixed-size sampler launches.

    One worker thread makes every launch (padding slots repeat the last real
    sample, so the sampler sees only valid pixels)."""

    def __init__(self, run_fn, batch: int, max_wait_s: float,
                 buckets=None, max_fill_wait_s: float = 0.25):
        self.run_fn = run_fn
        self.batch = batch
        # ascending launch sizes; a batch pads to the smallest bucket that
        # fits the gathered requests (always ends at `batch`)
        self.buckets = sorted(set(list(buckets or []) + [batch]))
        self.max_wait_s = max_wait_s
        self.max_fill_wait_s = max(max_fill_wait_s, max_wait_s)
        self.q: queue.Queue = queue.Queue()
        self.served = 0
        self.batches = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self.q.put(None)  # wake the worker
        self._thread.join(timeout=10)
        self._drain(RuntimeError("server shutting down"))

    def _drain(self, err: Exception):
        """Fail every still-queued slot so no submit() waits forever."""
        while True:
            try:
                s = self.q.get_nowait()
            except queue.Empty:
                return
            if s is not None:
                s["out"] = err
                s["event"].set()

    def submit(self, img: np.ndarray) -> np.ndarray:
        """Blocking: enqueue one (H, W, 3) uint8 image, wait for its
        restored output."""
        if self._stop.is_set():
            raise RuntimeError("server shutting down")
        slot = {"img": img, "event": threading.Event(), "out": None}
        self.q.put(slot)
        slot["event"].wait()
        if isinstance(slot["out"], Exception):
            raise slot["out"]
        return slot["out"]

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.25)
            except queue.Empty:
                continue
            if first is None:
                continue
            slots = [first]
            # arrival-renewed window: each new request renews max_wait,
            # bounded by a hard cap from the first pickup
            t0 = time.monotonic()
            cap = t0 + self.max_fill_wait_s
            deadline = min(t0 + self.max_wait_s, cap)
            while len(slots) < self.batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    s = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if s is None:
                    break
                slots.append(s)
                deadline = min(time.monotonic() + self.max_wait_s, cap)
            try:
                size = next(b for b in self.buckets if b >= len(slots))
                imgs = np.stack(
                    [s["img"] for s in slots]
                    + [slots[-1]["img"]] * (size - len(slots)))
                out = self.run_fn(imgs)  # (size, H, W, 3) uint8
                for i, s in enumerate(slots):
                    s["out"] = np.asarray(out[i])
            except Exception as e:  # noqa: BLE001 — fail the waiters
                traceback.print_exc()
                for s in slots:
                    s["out"] = e
            finally:
                self.batches += 1
                self.served += len(slots)
                for s in slots:
                    s["event"].set()


def mesh_devices(cfg: Config) -> list:
    """The devices of `--mesh-devices`: 0 means every local card, n means
    the first n, and more than `torch.cuda.device_count()` raises. With
    `device="cpu"`, n (at least 1) replicas on the CPU."""
    base = resolve_device(cfg.device, "serve")
    n = cfg.mesh_devices
    if n < 0:
        raise ValueError(f"mesh_devices must be >= 0, got {n}")
    if base.type != "cuda":
        return [base] * max(1, n)
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"mesh_devices={n}: this host has {count} CUDA "
                         "card(s)")
    return [torch.device("cuda", i) for i in range(n or count)]


class Runner:
    """What `build_runner` returns as `run`: `run(imgs, generator=None,
    latents_noise=None, posterior_noise=None) -> uint8 NHWC numpy`, the
    sampler's own signature on a uint8 NHWC numpy batch. Each call is one
    launch: it advances `counter`, moves the batch to the card through a
    pinned host buffer, calls the split sampler (noise from
    `seeded_generator(seed, counter)` unless given) and returns the faces on
    the host. Over several devices (`devices`, by default
    `mesh_devices(cfg)`) each takes a contiguous slice of the rows, and the
    noise is drawn for the whole batch on the first device.

    `sampler` is the first device's `RefinerSampler` (`samplers` every
    device's), `models` its (refiner, cr, vae), `captured` each bucket's
    `CapturedStages` on the first device after `warmup` (empty on the CPU;
    `replica_captures` every device's), `timings` the cold start's seconds
    by part. The captures hold for
    the models as they were at the warm-up: moving or casting them (`.to()`,
    also through building another sampler over them) or loading new weights
    drops them. Once anything is captured, a launch that did not replay
    (dropped captures, or a batch size that is not a bucket) raises
    RuntimeError after it ran."""

    def __init__(self, cfg: Config, devices=None):
        dtype = model_dtype(cfg.dtype)
        self.devices = [torch.device(d) for d in
                        (devices or mesh_devices(cfg))]
        self.device = self.devices[0]
        n = len(self.devices)
        self.size, self.seed = cfg.size, cfg.seed
        if cfg.batch % n:
            cfg.batch += -cfg.batch % n
            print(f"[serve] batch rounded up to {cfg.batch} ({n}-device "
                  "multiple)", flush=True)
        self.buckets = sorted({min(b + (-b % n), cfg.batch) for b in
                               parse_ints(cfg.buckets) + (cfg.batch,)
                               if b > 0})
        if len(self.buckets) > 1:
            print(f"[serve] launch buckets: {self.buckets}", flush=True)
        if n > 1:
            print(f"[serve] {n}-device data-parallel replicas "
                  f"({cfg.batch // n} faces/device/launch)", flush=True)
        self.timings = {}
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            kernels.library()
            self.timings["kernel_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.samplers, self.replicas = [], []
        for device in self.devices:
            cr, vae, refiner, self.latent = load_refiner_stack(cfg, device,
                                                               dtype)
            seams = load_tiny_seams(cfg, self.latent, device, dtype)
            self.replicas.append((refiner, cr, vae))
            self.samplers.append(build_refiner_sampler_split(
                refiner, cr, vae,
                RefinerPipelineConfig(
                    num_inference_steps=cfg.num_inference_steps,
                    latent_size=self.latent, sampler=cfg.sampler,
                    cache_interval=cfg.cache_interval, io_uint8=True,
                    clip_sample=True,
                    clip_sample_range=cfg.clip_sample_range),
                device=device, **seams))
        self.timings["load_s"] = time.perf_counter() - t0
        self.models, self.sampler = self.replicas[0], self.samplers[0]
        self.captured, self.replica_captures = {}, {}
        self.counter = 0
        self._pinned = {}

    def _upload(self, x: torch.Tensor, device: torch.device) -> torch.Tensor:
        if device.type != "cuda":
            return x
        key = (tuple(x.shape), device)
        pinned = self._pinned.get(key)
        if pinned is None:
            pinned = self._pinned[key] = torch.empty(
                x.shape, dtype=x.dtype, pin_memory=True)
        # the last launch's output copy has synchronized the stream, so the
        # buffer's previous upload has ended
        pinned.copy_(x)
        return pinned.to(device, non_blocking=True)

    def _noise(self, b: int, generator, latents_noise, posterior_noise):
        """The launch's noise for all `b` rows, drawn on the first device
        as its sampler would draw it (posterior noise first)."""
        shape = (b, self.latent, self.latent, 4)
        if posterior_noise is None and self.sampler._inputs.needs_posterior:
            posterior_noise = torch.randn(shape, generator=generator,
                                          device=self.device)
        if latents_noise is None:
            latents_noise = torch.randn(shape, generator=generator,
                                        device=self.device)
        return latents_noise, posterior_noise

    def __call__(self, imgs: np.ndarray,
                 generator: torch.Generator = None,
                 latents_noise: torch.Tensor = None,
                 posterior_noise: torch.Tensor = None) -> np.ndarray:
        self.counter += 1
        if generator is None:
            generator = seeded_generator(self.seed, self.counter,
                                         self.device)
        x = torch.from_numpy(np.ascontiguousarray(imgs))
        n = len(self.devices)
        if n > 1:
            latents_noise, posterior_noise = self._noise(
                len(imgs), generator, latents_noise, posterior_noise)
            generator = None
        per = len(imgs) // n
        samplers = [self.sampler] + self.samplers[1:]
        replays = [s.replays for s in samplers]
        outs = []
        for k, (device, sampler) in enumerate(zip(self.devices, samplers)):
            rows = slice(k * per, (k + 1) * per)

            def part(t):
                return None if t is None or n == 1 else t[rows].to(device)

            outs.append(sampler(
                self._upload(x[rows] if n > 1 else x, device), generator,
                part(latents_noise) if n > 1 else latents_noise,
                part(posterior_noise) if n > 1 else posterior_noise))
        if self.captured and any(s.replays != r + 1 for s, r in
                                 zip(samplers, replays)):
            raise RuntimeError(
                f"launch {self.counter} (batch {len(imgs)}) ran eagerly, "
                f"not as a replay of the warm-up's CUDA graphs (captured "
                f"buckets {sorted(self.captured)}): the batch is not a "
                "bucket, or the models were moved, cast or reloaded since "
                "the warm-up and the captures dropped")
        return np.concatenate([o.cpu().numpy() for o in outs])

    def warmup(self) -> float:
        """Capture each bucket's three stages on a zero batch (on every
        card, its slice of the bucket), then launch each bucket once;
        returns the seconds taken."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            n = len(self.devices)
            for b in self.buckets:
                self.replica_captures[b] = []
                for device, sampler in zip(self.devices, self.samplers):
                    zeros = torch.zeros((b // n, self.size, self.size, 3),
                                        dtype=torch.uint8, device=device)
                    noise = torch.zeros((b // n, self.latent, self.latent, 4),
                                        device=device)
                    self.replica_captures[b].append(sampler.warm_compile(
                        zeros, latents_noise=noise, posterior_noise=noise))
                self.captured[b] = self.replica_captures[b][0]
            for device in self.devices:
                torch.cuda.synchronize(device)
            self.timings["capture_s"] = time.perf_counter() - t0
            print(f"[serve] {len(self.buckets)} buckets x 3 stages x "
                  f"{n} device(s) captured in "
                  f"{self.timings['capture_s']:.1f}s", flush=True)
        t1 = time.perf_counter()
        for b in self.buckets:
            self(np.zeros((b, self.size, self.size, 3), np.uint8))
        self.timings["first_launch_s"] = time.perf_counter() - t1
        return time.perf_counter() - t0


def build_runner(cfg: Config):
    """Build the kernels (on the card), load the model stack and build the
    sampler; returns (run, warmup, buckets): the `Runner`, its warm-up and
    the ascending launch sizes."""
    runner = Runner(cfg)
    return runner, runner.warmup, runner.buckets


def make_handler(batcher: _Batcher, cfg: Config):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            fills = (batcher.served / batcher.batches
                     if batcher.batches else 0.0)
            self._json(200, {
                "status": "ok", "batch": batcher.batch,
                "buckets": batcher.buckets,
                "steps": cfg.num_inference_steps,
                "cache_interval": cfg.cache_interval,
                "sampler": cfg.sampler, "served": batcher.served,
                "batches": batcher.batches,
                "mean_fill": round(fills, 2),
            })

        MAX_BODY = 32 << 20  # PNG bodies; raw is checked exactly below

        def do_POST(self):
            if self.path != "/infer":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                return self._json(400, {"error": "bad Content-Length"})
            if not 0 < n <= self.MAX_BODY:
                return self._json(400, {
                    "error": f"Content-Length must be in (0, "
                             f"{self.MAX_BODY}], got {n}"})
            body = self.rfile.read(n)
            ctype = self.headers.get("Content-Type",
                                     "application/octet-stream")
            try:
                if ctype == "image/png" or body[:8] == PNG_SIGNATURE:
                    img = resize_pil(decode_image(body, reader="pil"),
                                     (cfg.size, cfg.size), "bicubic")
                    png = True
                else:
                    expect = cfg.size * cfg.size * 3
                    if len(body) != expect:
                        return self._json(400, {
                            "error": f"raw body must be {expect} bytes "
                                     f"(size*size*3 uint8 RGB), "
                                     f"got {len(body)}"})
                    img = np.frombuffer(body, np.uint8).reshape(
                        cfg.size, cfg.size, 3)
                    png = False
            except Exception as e:  # noqa: BLE001
                return self._json(400, {"error": f"bad image: {e}"})
            try:
                out = batcher.submit(img)
            except Exception as e:  # noqa: BLE001
                return self._json(500, {"error": f"inference failed: {e}"})
            if png:
                payload, out_type = png_bytes(out), "image/png"
            else:
                payload, out_type = out.tobytes(), "application/octet-stream"
            self.send_response(200)
            self.send_header("Content-Type", out_type)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    return Handler


def create_server(cfg: Config):
    """Build and warm the model, return (httpd, batcher). Caller runs
    `httpd.serve_forever()` (tests run it in a thread) and stops with
    `httpd.shutdown(); batcher.stop()`. `batcher.run_fn` is the `Runner`."""
    run, warmup, buckets = build_runner(cfg)
    batcher = _Batcher(run, cfg.batch, cfg.max_wait_ms / 1e3,
                       buckets=buckets,
                       max_fill_wait_s=cfg.max_fill_wait_ms / 1e3)
    dt = warmup()
    print(f"[serve] model warm ({dt:.1f}s); batch={cfg.batch} "
          f"buckets={buckets} steps={cfg.num_inference_steps} "
          f"cache={cfg.cache_interval} sampler={cfg.sampler} "
          f"device={run.device}", flush=True)
    batcher.start()
    httpd = _Server((cfg.host, cfg.port), make_handler(batcher, cfg))
    return httpd, batcher


def main(argv=None):
    cfg = parse_config(Config, argv, "Batching inference server")
    httpd, batcher = create_server(cfg)
    print(f"[serve] listening on http://{httpd.server_address[0]}:"
          f"{httpd.server_address[1]} (POST /infer, GET /healthz)",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        batcher.stop()


if __name__ == "__main__":
    main()
