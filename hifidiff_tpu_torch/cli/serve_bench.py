"""Serving-under-load benchmark of the port's server (counterpart of
scripts/serve_bench.py): concurrent HTTP clients against `cli/serve.py`, and
per concurrency the p50 / p95 latency a client sees (HTTP, queueing, the
batcher's bucket choice and padding, the launch), faces/s, launches and the
mean fill of a launch.

  * c=1  : one sequential client (the batch-1 bucket)
  * c=4  : small bursts (typically the 4-bucket)
  * c=16 : the full launch batch
  * c=32 : 2x oversubscription (queueing, launches back to back)

Random weights: serving performance, not output quality.

    python -m hifidiff_tpu_torch.cli.serve_bench            # exact DDIM-50
    python -m hifidiff_tpu_torch.cli.serve_bench --steps 10 --out bench.json

`run_load` drives a server that is already up (chip_smoke.py uses it).
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time

import numpy as np


def client_worker(host, port, size, n_requests, latencies, errors, seed):
    rng = np.random.default_rng(seed)
    body = rng.integers(0, 256, (size, size, 3), np.uint8).tobytes()
    conn = http.client.HTTPConnection(host, port, timeout=120)
    for _ in range(n_requests):
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/infer", body,
                         {"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200 or len(payload) != len(body):
                errors.append(f"status={resp.status} len={len(payload)}")
                continue
        except Exception as e:  # noqa: BLE001
            errors.append(str(e))
            conn.close()
            conn = http.client.HTTPConnection(host, port, timeout=120)
            continue
        latencies.append(time.perf_counter() - t0)
    conn.close()


def healthz(host, port):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request("GET", "/healthz")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def run_phase(host, port, size, concurrency, n_requests):
    """`concurrency` clients, `n_requests` requests each; the phase's
    numbers as a dict."""
    latencies: list = []
    errors: list = []
    before = healthz(host, port)
    threads = [threading.Thread(
        target=client_worker,
        args=(host, port, size, n_requests, latencies, errors, 1000 + i))
        for i in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        print(f"[serve_bench] c={concurrency} error detail: "
              f"{errors[:4]}", flush=True)
    after = healthz(host, port)
    lat_ms = sorted(x * 1e3 for x in latencies)
    launches = after["batches"] - before["batches"]
    served = after["served"] - before["served"]
    return {
        "concurrency": concurrency,
        "requests": len(lat_ms),
        "errors": len(errors),
        "p50_ms": lat_ms[len(lat_ms) // 2] if lat_ms else None,
        "p95_ms": (lat_ms[min(len(lat_ms) - 1, int(len(lat_ms) * 0.95))]
                   if lat_ms else None),
        "throughput_faces_per_sec": len(lat_ms) / wall,
        "launches": launches,
        "mean_fill": served / launches if launches else None,
    }


def run_load(host, port, size, concurrencies, n_requests):
    """One phase per concurrency, each after a throwaway request; returns
    the phases' dicts."""
    phases = []
    for c in concurrencies:
        run_phase(host, port, size, 1, 1)
        ph = run_phase(host, port, size, c, n_requests)
        phases.append(ph)
        print(f"[serve_bench] c={c}: p50 {ph['p50_ms']} ms, "
              f"p95 {ph['p95_ms']} ms, "
              f"{ph['throughput_faces_per_sec']} faces/s, "
              f"launches {ph['launches']}, fill {ph['mean_fill']}, "
              f"errors {ph['errors']}", flush=True)
    return phases


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--sampler", default="ddim")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--buckets", default="1,4")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--requests", type=int, default=16,
                   help="requests per client per phase")
    p.add_argument("--concurrencies", default="1,4,16,32")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from hifidiff_tpu_torch.cli import serve

    cfg = serve.Config(port=0, batch=args.batch, buckets=args.buckets,
                       num_inference_steps=args.steps, sampler=args.sampler,
                       size=args.size)
    print("[serve_bench] building and warming the server (one graph set "
          "per bucket)...", flush=True)
    t0 = time.perf_counter()
    httpd, batcher = serve.create_server(cfg)
    host, port = httpd.server_address
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    warm_s = time.perf_counter() - t0
    print(f"[serve_bench] up on :{port} in {warm_s:.1f}s", flush=True)
    try:
        phases = run_load(host, port, args.size,
                          [int(x) for x in args.concurrencies.split(",")],
                          args.requests)
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()

    result = {
        "description": (
            "Measured through the port's HTTP server (hifidiff_tpu_torch/"
            "cli/serve.py) with concurrent clients on one CUDA device: "
            "request-to-response latency incl. HTTP + dynamic batching + "
            "bucket padding + the launch. Random weights (serving "
            "performance, not output quality)."),
        "config": {"steps": args.steps, "sampler": args.sampler,
                   "batch": args.batch, "buckets": args.buckets,
                   "size": args.size, "requests_per_client": args.requests,
                   "warmup_s": warm_s},
        "phases": phases,
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"[serve_bench] wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
