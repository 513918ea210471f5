#!/usr/bin/env python
"""Smoke run of the main path on one GPU, at deployment widths, in one
process.

    python chip_smoke.py          # phases 0-4 on one card
    python chip_smoke.py --four   # the sharded path on four cards, only

Phases (each prints its checks; any failure exits non-zero and the result
line is not printed):

  0. device: JAX must find a GPU (never falls back to the CPU).
  1. flagship batch detection: `MinnRTLDetector.detect_batch` (the fused
     Triton kernel) over 512 streams x 2^18 samples x 2 branches, float32
     and int16, against the plain XLA reference (`ops.metrics.
     minn_rtl_metric` + `ops.detect.extract_gate_events`) jitted on the card
     and the C++ fixed-point oracle (`native/`) on 4 streams.
  2. live stream step: `minn_rtl_stream_step` over 64 chunks of 4096
     samples on 64 streams; the finalized table equals one-shot detection.
  3. receive chains through the CLI (`python -m ofdm_sync_tpu fused_rx`),
     in this process, with the bounds the CPU tests assert.
  4. ZC streaming CFAR from IQ: `ZCStreamingDetector.detect_batch`
     (overlap-save cuFFT matched filter) over 64 streams x 2^18 samples
     against `ZCStreamingDetector.detect` per stream.

With --four: Minn-RTL detection sharded over 'seq' on mesh (1, 4) and over
'data' on mesh (4, 1), and the sharded receive chain with a frame across a
seam, each equal to the single-card result on device 0.

The last stdout line is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

try:
    from ofdm_sync_tpu.conformance import device_checks as dc  # noqa: E402
except ImportError as e:  # run outside a checkout of the repository
    sys.exit(f"chip_smoke: the ofdm_sync_tpu package is missing ({e})")

Q = 512
KW = dict(quarter_len=Q, smooth_shift=3,
          threshold_value=int(0.10 * (1 << 15)), threshold_frac_bits=15,
          hysteresis=2, max_events=8)
BATCH, L = 512, 1 << 18

FAILURES: list[str] = []


def check(name: str, errs: list[str]) -> None:
    print(f"  [{'ok' if not errs else 'FAIL'}] {name}", flush=True)
    for e in errs:
        print(f"      {e}", flush=True)
    if errs:
        FAILURES.append(name)


def timed(fn, *args, reps: int = 10):
    """Median and min seconds per call, each ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts))


def phase_device():
    import jax

    d = jax.devices()[0]
    print(f"phase 0: device platform={d.platform} kind={d.device_kind} "
          f"count={len(jax.devices())}", flush=True)
    if d.platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform {d.platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    return smi


def phase_flagship(card: str):
    import jax
    import jax.numpy as jnp

    from ofdm_sync_tpu.models.detectors import MinnRTLDetector
    from ofdm_sync_tpu.native import minn_rtl_detect_native
    from ofdm_sync_tpu.ops import metrics as M
    from ofdm_sync_tpu.ops.detect import extract_gate_events
    from ofdm_sync_tpu.params import MinnRTLParams

    print(f"phase 1: Minn-RTL batch detection, {BATCH} streams x {L} "
          "samples x 2 branches", flush=True)
    det = MinnRTLDetector(params=MinnRTLParams(quarter_len=Q))
    x = dc.minn_stimulus(BATCH, L, Q)

    def plain_one(stream):  # (4, L) planar -> complex branches
        st = M.minn_rtl_metric(
            stream[0::2] + 1j * stream[1::2], quarter_len=Q,
            smooth_shift=KW["smooth_shift"],
            threshold_value=KW["threshold_value"],
            threshold_frac_bits=KW["threshold_frac_bits"],
        )
        return extract_gate_events(
            st.above_threshold, st.corr_positive,
            hysteresis=KW["hysteresis"], max_events=KW["max_events"],
            valid_from=M.minn_rtl_valid_from(Q), tie="last",
            emit_unclosed=False,
        )

    plain = jax.jit(
        lambda v: jax.lax.map(plain_one, jnp.moveaxis(v, 1, 0),
                              batch_size=32)
    )
    ref = plain(x)
    n_ev = int(np.asarray(ref.count).sum())
    print(f"  plain reference: {n_ev} events", flush=True)
    if n_ev < BATCH // 8:
        check("stimulus has events", [f"only {n_ev} events"])

    detect = jax.jit(det.detect_batch)
    for name, xx in (("float32", x), ("int16", x.astype(jnp.int16))):
        t0 = time.perf_counter()
        compiled = detect.lower(xx).compile()
        t_compile = time.perf_counter() - t0
        out = compiled(xx)
        check(f"kernel == plain reference ({name})",
              dc.table_diff(ref, out, name=name))
        med, best = timed(compiled, xx)
        print(f"  {name}: compile {t_compile:.2f} s, {med * 1e3:.3f} ms "
              f"per call (min {best * 1e3:.3f}), "
              f"{BATCH * L / med / 1e9:.2f} G samples/s on {card}",
              flush=True)
        print(f"  {name}: {compiled.memory_analysis()}", flush=True)
    t_ref = timed(plain, x, reps=3)[0]
    print(f"  plain reference: {t_ref * 1e3:.3f} ms per call on {card}",
          flush=True)

    # the C++ fixed-point oracle on 4 streams that carry preambles.  Its
    # smoothing is the RTL's integer arithmetic shift, which stalls within
    # 2^smooth_shift of the float EMA, so a threshold crossing may move by
    # a sample: gate edges within the reference testbench's +-16-sample
    # RTL tolerance (ref/test_minn_preamble_detector.py:446-451); counts,
    # peak indices and peak values (exact integers) must be equal.
    out = jax.device_get(det.detect_batch(x))
    xh = np.asarray(x[:, :32:8]).astype(np.int16)
    errs = []
    for k, b in enumerate(range(0, min(32, BATCH), 8)):
        nat = minn_rtl_detect_native(
            xh[:, k].reshape(2, 2, L), quarter_len=Q,
            smooth_shift=KW["smooth_shift"],
            threshold_value=KW["threshold_value"],
            threshold_frac_bits=KW["threshold_frac_bits"],
            hysteresis=KW["hysteresis"], max_events=KW["max_events"],
        )
        c = int(out.count[b])
        if nat.count != c:
            errs.append(f"stream {b}: {nat.count} oracle events vs {c}")
            continue
        for f in ("peak_idx", "peak_value", "closed"):
            if not np.array_equal(getattr(nat, f), getattr(out, f)[b, :c]):
                errs.append(f"stream {b}: {f} differs")
        for f in ("gate_start", "gate_close"):
            d = np.abs(getattr(nat, f) - getattr(out, f)[b, :c])
            if d.size and d.max() > 16:
                errs.append(f"stream {b}: {f} off by {int(d.max())}")
    check("kernel == C++ oracle (4 streams)", errs)


def phase_stream_step(card: str):
    import jax
    import jax.numpy as jnp

    from ofdm_sync_tpu.kernels.minn_rtl_triton import minn_rtl_detect
    from ofdm_sync_tpu.kernels.streaming_chunked import (
        MinnRTLStreamParams, minn_rtl_stream_finalize, minn_rtl_stream_init,
        minn_rtl_stream_step,
    )

    B, n_chunks, chunk = 64, 64, 4096
    print(f"phase 2: live stream step, {B} streams x {n_chunks} chunks of "
          f"{chunk}", flush=True)
    params = MinnRTLStreamParams(**KW)
    x = dc.minn_stimulus(B, n_chunks * chunk, Q, every=2, seed=1)
    streams = jnp.moveaxis(x, 1, 0).reshape(B, 2, 2, n_chunks * chunk)
    step = jax.jit(jax.vmap(
        lambda s, c: minn_rtl_stream_step(s, c, params=params)
    ))
    state = jax.vmap(lambda _: minn_rtl_stream_init(params, 2))(
        jnp.arange(B)
    )
    lat = []
    for k in range(n_chunks):
        c = streams[..., k * chunk:(k + 1) * chunk]
        t0 = time.perf_counter()
        state = jax.block_until_ready(step(state, c))
        lat.append(time.perf_counter() - t0)
    table = jax.vmap(
        lambda s: minn_rtl_stream_finalize(s, params=params)
    )(state)
    one_shot = minn_rtl_detect(x, **KW)
    check("stitched stream table == one-shot detection",
          dc.table_diff(one_shot, table, name="stream"))
    lat = np.asarray(lat[1:]) * 1e3
    print(f"  per-chunk step ({B} streams): p50 {np.median(lat):.3f} ms, "
          f"p99 {np.percentile(lat, 99):.3f} ms on {card}", flush=True)


_FRAME = re.compile(
    r"Frame (\d+): start (\d+) \(true (\d+), error ([+-]?\d+)\), "
    r"CFO ([-\d.]+) Hz \(error ([+-]?[\d.]+)\), EVM ([\d.]+)%"
)


def phase_cli():
    from ofdm_sync_tpu.__main__ import main

    print("phase 3: receive chains through the CLI", flush=True)
    cases = (
        # AWGN at 0 dB: both frames within the RTL's +-16-sample
        # conformance precedent; CFO within the detection-quality bound
        (["fused_rx", "--family", "minn_rtl"], 2,
         lambda t: abs(t) <= 16),
        # measured channel cir1: timing offset is the channel group delay
        # -- positive and inside one preamble (test_detection_quality)
        (["fused_rx", "--num-frames", "2", "--channel", "cir1"], 2,
         lambda t: 0 <= t < 1024),
    )
    for argv, n_frames, timing_ok in cases:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        text = buf.getvalue()
        print(text, flush=True)
        frames = _FRAME.findall(text)
        errs = [] if rc == 0 else [f"exit code {rc}"]
        if len(frames) < n_frames:
            errs.append(f"{len(frames)} frames recovered, {n_frames} sent")
        for f in frames:
            terr, cerr, evm = int(f[3]), float(f[5]), float(f[6])
            if not timing_ok(terr):
                errs.append(f"frame {f[0]}: timing error {terr}")
            if not abs(cerr) < 300.0:
                errs.append(f"frame {f[0]}: CFO error {cerr} Hz")
            if not np.isfinite(evm):
                errs.append(f"frame {f[0]}: EVM {evm}")
        check(" ".join(argv), errs)


def phase_zc(card: str):
    import jax
    import jax.numpy as jnp

    from ofdm_sync_tpu.models.base import events_from_table
    from ofdm_sync_tpu.models.detectors import ZCStreamingDetector

    B = 64
    print(f"phase 4: ZC streaming CFAR from IQ, {B} streams x {L} samples "
          "x 2 branches, 2048-tap PSS matched filter", flush=True)
    det = ZCStreamingDetector()
    ref = det.reference_waveform()
    R = ref.shape[-1]
    tmpl = ref / np.sqrt(np.mean(np.abs(ref) ** 2))
    planes = np.stack([np.round(8 * tmpl.real), np.round(8 * tmpl.imag)] * 2)
    rng = np.random.default_rng(2)
    streams = np.arange(0, B, 2)
    pos = rng.integers(R, L - 2 * R, size=len(streams))

    @jax.jit
    def build(key):
        v = jnp.round(4.0 * jax.random.normal(key, (4, B, L), jnp.float32))
        return v.at[:, jnp.asarray(streams)[:, None],
                    jnp.asarray(pos)[:, None] + jnp.arange(R)[None, :]
                    ].add(jnp.asarray(planes, jnp.float32)[:, None, :])

    iq = build(jax.random.key(2))
    table = det.detect_batch(iq)
    med, best = timed(det.detect_batch, iq, reps=5)
    print(f"  detect_batch: {med * 1e3:.3f} ms per call (min "
          f"{best * 1e3:.3f}), {B * L / med / 1e9:.3f} G samples/s on "
          f"{card}", flush=True)
    table = jax.device_get(table)
    n = L + R - 1
    # Tolerance: detect_batch's overlap-save transforms and detect's one
    # monolithic transform round differently (~1e-6 of the largest output).
    # The planted peaks reach ~1.6 against the 0.3 floor and the
    # 4x-local-mean CFAR, so counts and peak indices must be equal; a gate
    # edge is a threshold crossing and may move by a sample where |corr|
    # lies within that rounding of the threshold, so edges are held to +-2
    # samples and peak values to rtol 1e-4.  Events that start in the
    # ramp-down tail of the 'full' correlation (outputs >= L, whose window
    # holds fewer than R stream samples) are not compared: there the
    # normalization divides the FFT rounding by a vanishing power, so both
    # forms return rounding noise.
    errs, peaks = [], []
    x_c = np.asarray(iq[0::2] + 1j * iq[1::2])
    for b in range(B):
        res = [e for e in det.detect(x_c[:, b]).events if e.gate_start < L]
        got = [g for g in events_from_table(
            jax.tree.map(lambda a: a[b], table), n, gate_end_mode="close"
        ) if g["gate_start"] < L]
        if len(got) != len(res):
            errs.append(f"stream {b}: {len(got)} events vs {len(res)}")
            continue
        for e, g in zip(res, got):
            peaks.append(e.peak_value)
            if e.peak_index != g["peak_index"]:
                errs.append(f"stream {b}: peak {g['peak_index']} vs "
                            f"{e.peak_index}")
            if (abs(e.gate_start - g["gate_start"]) > 2
                    or abs(e.gate_end - g["gate_end"]) > 2):
                errs.append(f"stream {b}: gate edges differ")
            if not np.isclose(g["peak_value"], e.peak_value, rtol=1e-4):
                errs.append(f"stream {b}: peak value differs")
    if len(peaks) < len(streams):
        errs.append(f"only {len(peaks)} events for {len(streams)} planted")
    print(f"  {len(peaks)} events, smallest peak |corr| "
          f"{min(peaks, default=0.0):.3f}", flush=True)
    check("detect_batch == detect per stream", errs)


def phase_four(card: str):
    import jax

    from ofdm_sync_tpu.models.detectors import MinnRTLDetector
    from ofdm_sync_tpu.ops.waveforms import build_minn_rtl_preamble
    from ofdm_sync_tpu.params import MinnRTLParams, SYS_30M72
    from ofdm_sync_tpu.pipelines import common

    devices = jax.devices()
    if len(devices) != 4:
        sys.exit(f"chip_smoke --four: needs 4 cards, JAX found "
                 f"{len(devices)}")
    print(f"phase 5: sharded path on 4 cards ({card})", flush=True)
    x = dc.minn_stimulus(BATCH, L, Q)
    t0 = time.perf_counter()
    for name, errs in dc.sharded_detection_errors(x, devices, KW).items():
        check(f"sharded detection, {name} == device 0", errs)
    print(f"  sharded detection checks: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # two 30.72 MHz frames; the first, [1337, 9017), spans the 8192 seam
    rng = np.random.default_rng(0)
    params = MinnRTLParams(quarter_len=Q)
    preamble = build_minn_rtl_preamble(params.seq_type, rng, Q=Q,
                                       sys=SYS_30M72)
    setup = common.build_setup(
        preamble, rng, sys=SYS_30M72, channel_name=None, cir_mode="two",
        snr_db=30.0, cfo_hz=1000.0, two_frames=True,
    )
    check("sharded receive chain == device 0", dc.sharded_receive_errors(
        setup.rx, devices, MinnRTLDetector(SYS_30M72, params),
        frame_len=setup.extras["frame_len"], L=4 * 8192,
    ))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path, on four cards")
    args = ap.parse_args()

    from ofdm_sync_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    card = phase_device()
    if args.four:
        phase_four(card)
    else:
        phase_flagship(card)
        phase_stream_step(card)
        phase_cli()
        phase_zc(card)
    if FAILURES:
        print(f"chip_smoke: FAILED: {FAILURES}", flush=True)
        return 1
    d = jax.devices()[0]
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
