#!/usr/bin/env python
"""Headline benchmark: Minn-RTL batch detection throughput on one GPU.

Prints ONE JSON line, e.g.
  {"metric": "iq_samples_per_sec_per_chip", "value": N, "unit": "samples/s",
   "platform": "gpu", "device_kind": ..., "device_count": 1,
   "card": "<nvidia-smi name>, <power limit>", ...}

Workload: the flagship Minn-RTL detector (Q=512, 2 RX branches, fixed-point
threshold + gate/peak event tables) over 512 device-resident streams of
2^18 samples, through `MinnRTLDetector.detect_batch` (the fused Triton
kernel), float32 and int16 ingest; plus the per-chunk latency of the
carried-state stream step (`minn_rtl_stream_step`, 4096-sample chunks).
Every timed call ends in `block_until_ready`.  Runs in one process and
fails when JAX finds no GPU.

`vs_baseline` divides by the reference implementation's per-sample Python
loop (reference minn_rtl.py:667-733), 131,681 IQ samples/s measured on a
CPU for the same 2-branch workload (BASELINE.md).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BASELINE_SAMPLES_PER_SEC = 131_681.0  # reference Python loop, on a CPU
BATCH, STREAM_LEN, CHUNK = 512, 1 << 18, 4096


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def _seconds_per_call(fn, *args, reps: int = 20) -> list[float]:
    import jax

    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def main() -> int:
    from ofdm_sync_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from ofdm_sync_tpu.conformance.device_checks import minn_stimulus
    from ofdm_sync_tpu.kernels.streaming_chunked import (
        MinnRTLStreamParams, minn_rtl_stream_init, minn_rtl_stream_step,
    )
    from ofdm_sync_tpu.models.detectors import MinnRTLDetector

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX runs on {dev.platform}",
              file=sys.stderr)
        return 1
    det = MinnRTLDetector()
    p = det.params
    x = minn_stimulus(BATCH, STREAM_LEN, p.quarter_len)
    detect = jax.jit(det.detect_batch)
    rates = {}
    for name, xx in (("float32", x), ("int16", x.astype(jnp.int16))):
        t = np.median(_seconds_per_call(detect, xx))
        rates[name] = BATCH * STREAM_LEN / t
    del x

    params = MinnRTLStreamParams(
        quarter_len=p.quarter_len, smooth_shift=p.smooth_shift,
        threshold_value=p.threshold_value,
        threshold_frac_bits=p.threshold_frac_bits, hysteresis=p.hysteresis,
    )
    step = jax.jit(lambda s, c: minn_rtl_stream_step(s, c, params=params))
    chunk = jax.random.normal(jax.random.key(3), (2, 2, CHUNK), jnp.float32)
    state = minn_rtl_stream_init(params, 2)
    lat = []
    for _ in range(200):
        t0 = time.perf_counter()
        state = jax.block_until_ready(step(state, chunk))
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat[10:]) * 1e3

    print(json.dumps({
        "metric": "iq_samples_per_sec_per_chip",
        "value": round(rates["float32"]),
        "unit": "samples/s",
        "int16_value": round(rates["int16"]),
        "vs_baseline": round(rates["float32"] / BASELINE_SAMPLES_PER_SEC, 1),
        "block_latency_p50_ms": round(float(np.median(lat_ms)), 4),
        "block_latency_p99_ms": round(float(np.percentile(lat_ms, 99)), 4),
        "batch": BATCH, "stream_len": STREAM_LEN, "chunk": CHUNK,
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()), "card": _card(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
