"""Does a `torch.profiler` trace slow the launches that follow it?

    python3 scripts/torch_profiler_effect.py        (from the repo root)

Needs one CUDA device and nvcc (it launches `matmul_w8`). Times, before and
after profiler traces in the same process: 20,000 eager `add_` launches and
1,500 rounds of a small conv + SiLU + add on the host's clock, and
`matmul_w8` at (128, 2048, 2048) eagerly and by CUDA-graph replay
(`chip_smoke.time_ms`, weights beyond L2). Then the cost of one trace over
21,000 launches with and without the host's operators traced, and how many
device events each reports. chip_smoke.py orders its phases by what this
prints: every timing first, the profiler last, device events only.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from hifidiff_tpu_torch.ops import quant


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    small = torch.zeros(1024, device=dev)
    img = torch.randn(8, 64, 16, 16, device=dev).bfloat16()
    w = torch.randn(64, 64, 3, 3, device=dev).bfloat16()

    def eager_small(n=20000):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            small.add_(1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def eager_mix(n=1500):
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = img
        with torch.inference_mode():
            for _ in range(n):
                y = F.silu(F.conv2d(y, w, padding=1)) * 0.1 + img
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(128, 2048, generator=g, device=dev).bfloat16()
    wq, scale = quant.quantize_weight_per_cout(
        torch.randn(2048, 2048, generator=g, device=dev))
    calls = [lambda w=w: quant.matmul_w8(x, w, scale)
             for w in [wq] + [wq.clone() for _ in range(15)]]

    def graph_w8():
        with torch.inference_mode():
            return chip_smoke.time_ms(calls, 20)

    def readings(tag):
        a = [round(eager_small(), 1) for _ in range(5)]
        b = [round(eager_mix(), 1) for _ in range(5)]
        c = [tuple(round(v * 1e3, 2) for v in graph_w8()) for _ in range(3)]
        print(f"{tag}: add_ x20000 ms {a} | conv mix x1500 ms {b} | "
              f"matmul_w8 (eager, graph) us {c}", flush=True)

    graph_w8(), eager_small(2000), eager_mix(100)      # warm up
    readings("before any trace")
    readings("before any trace")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for f in calls:
            f()
        torch.cuda.synchronize()
    readings("after one trace ")
    readings("after one trace ")
    for activities in ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       [ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            eager_mix(3000)
        t1 = time.perf_counter()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in rows) / 1e3
        events = sum(e.device_type == DeviceType.CUDA for e in prof.events())
        print(f"{[a.name for a in activities]}: trace {t1 - t0:.2f} s, "
              f"reading it {time.perf_counter() - t1:.2f} s, device time "
              f"{device_ms:.1f} ms in {events} device events of 21000 "
              "launches", flush=True)
        del prof
    readings("after three       ")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
