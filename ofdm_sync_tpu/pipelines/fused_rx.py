"""End-to-end receive chains on the device.

The reference-parity pipelines mirror the reference scripts' math and
prints; this demo drives the deployment path instead: the [A][A] detector
(event table out, CFO captured at the peak, reference sync_aa.py:421-571 +
docs/aa_preamble_sync_design.md sections 7-9) or the flagship Minn-RTL
detector, then **device-side aligned frame re-emission** (the RTL
detector's output contract: circular buffer + timer queue,
ref/minn_preamble_detector.sv:445-530, re-expressed as a capacity-bounded
batched dynamic-slice — `ops.extract`), then the standard receive stages
on each recovered frame: CFO correction, pilot LS channel estimate, data
equalization, EVM (the stage shape of reference sc.py:279-309, on the
10 MHz AA system).  Multi-frame streams (reference minn_rtl.py:884-888
transmits two frames) recover every frame from one detection pass.

Run: ``python -m ofdm_sync_tpu fused_rx [--family minn_rtl] [--snr 10]
[--channel cir1] [--num-frames 2]``.  Synthesis, channel, detection, frame
re-emission and demodulation all run on JAX's default device; on a GPU the
Minn-RTL detection is the fused Triton kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from ofdm_sync_tpu.params import AADetectorParams, SYS_AA_10M
from ofdm_sync_tpu.models.detectors import AADetector
from ofdm_sync_tpu.ops.channel import (
    apply_cfo,
    apply_channel_multi_antenna,
    compute_clipping_stats,
    quantize_adc,
)
from ofdm_sync_tpu.ops.estimate import (
    align_complex_gain,
    equalize,
    evm_rms_db,
    ls_channel_estimate,
)
from ofdm_sync_tpu.ops.waveforms import (
    build_aa_preamble,
    build_aa_qpsk_symbol,
    ofdm_fft_used,
)
from ofdm_sync_tpu.utils import report

SYS = SYS_AA_10M

SNR_DB = 10.0
CFO_HZ = 500.0
PREAMBLE_LEN = 1024
FULL_SCALE_RATIO = 2.0
SEED = 42


@dataclass
class FrameResult:
    timing_error: int
    cfo_error_hz: float
    evm_pct: float
    evm_db: float


@dataclass
class FusedRxResult:
    detected: bool
    timing_error: int
    cfo_error_hz: float
    evm_pct: float
    evm_db: float
    frames: list = field(default_factory=list)  # per-frame FrameResult


def run_fused_rx(
    snr_db: float = SNR_DB,
    channel_name: str | None = None,
    cfo_hz: float = CFO_HZ,
    preamble_length: int = PREAMBLE_LEN,
    full_scale_ratio: float = FULL_SCALE_RATIO,
    seed: int = SEED,
    num_frames: int = 1,
) -> FusedRxResult:
    """Synthesize `num_frames` AA frames, detect them, re-emit each aligned
    frame window ON DEVICE, and demodulate:
    detect -> frame windows + CFO from the event table -> correct -> LS EQ
    on the pilot -> EVM on the data symbol, per frame."""
    rng = np.random.default_rng(seed)
    fs = SYS.sample_rate_hz

    # --- transmit: [pad | frame | gap | frame ... | pad] ------------------
    # (two-frame stream shape: reference minn_rtl.py:884-888)
    preamble, _, papr_db = build_aa_preamble(preamble_length, SYS)
    pilot_symbol, pilot_used = build_aa_qpsk_symbol(rng, SYS)
    data_symbol, data_used = build_aa_qpsk_symbol(rng, SYS)
    frame = np.concatenate([
        np.asarray(preamble), np.asarray(pilot_symbol),
        np.asarray(data_symbol),
    ])
    flen = frame.shape[0]
    parts = [np.zeros(SYS.tx_pre_pad, complex)]
    tx_starts = []
    pos = SYS.tx_pre_pad
    for k in range(num_frames):
        parts.append(frame)
        tx_starts.append(pos)
        pos += flen
        if k < num_frames - 1:
            parts.append(np.zeros(flen, complex))
            pos += flen
    parts.append(np.zeros(500, complex))
    tx = np.concatenate(parts)

    # --- channel + CFO + 12-bit ADC (reference sync_aa.py:712-735) --------
    rx, _cir, channel_peak_offset = apply_channel_multi_antenna(
        tx, snr_db, rng, channel_name, num_rx_antennas=2
    )
    true_starts = [s + channel_peak_offset for s in tx_starts]
    rx = np.asarray(
        apply_cfo(jnp.asarray(rx, jnp.complex64), cfo_hz, fs)
    )
    full_scale = float(
        np.sqrt(np.mean(np.abs(rx) ** 2)) * full_scale_ratio
    )
    clip = compute_clipping_stats(rx.flatten(), full_scale)
    rx_q = np.asarray(
        quantize_adc(jnp.asarray(rx, jnp.complex64), full_scale)
    )

    # --- detect + re-emit aligned frames, all on device -------------------
    det = AADetector(SYS, AADetectorParams(preamble_len=preamble_length))
    result, frames_dev, starts, valid = det.detect_frames(
        rx_q, frame_len=flen, max_frames=4
    )
    best = AADetector.best(result)

    channel_str = channel_name if channel_name else "awgn"
    report.banner(
        f"RECEIVE CHAIN - [A][A] {preamble_length}, "
        f"{channel_str.upper()}, SNR {snr_db:+.0f} dB"
    )
    print(f"Stream: {rx_q.shape[1]} samples x {rx_q.shape[0]} antennas, "
          f"12-bit ADC (clipping {clip['total_clip_pct']:.2f}%), "
          f"preamble PAPR {papr_db:.2f} dB, {num_frames} frame(s) sent")
    if best is None or not valid.any():
        print("NO DETECTION -- receiver idle")
        return FusedRxResult(False, -1, float("nan"), float("nan"),
                             float("nan"))

    n_det = int(valid.sum())
    print(f"\nDetection (event table -> device-side frame "
          f"re-emission, {n_det} frame window(s)):")

    # --- receive stages per recovered frame -------------------------------
    frame_results: list[FrameResult] = []
    events = result.events
    for k in range(n_det):
        ev = events[k] if k < len(events) else None
        tstart = true_starts[k] if k < len(true_starts) else true_starts[-1]
        timing_err = int(starts[k]) - tstart
        cfo_est = ev.cfo_hz if ev is not None else 0.0
        cfo_err = cfo_est - cfo_hz
        fp = frames_dev[k]  # planar (2*BR, flen) float32
        ants = np.stack([
            fp[2 * b] + 1j * fp[2 * b + 1]
            for b in range(fp.shape[0] // 2)
        ])
        # local-index CFO correction: the constant phase offset vs the
        # stream-absolute correction is absorbed by the LS estimate
        ants = np.asarray(
            apply_cfo(jnp.asarray(ants, jnp.complex64), -cfo_est, fs)
        )
        combined = ants.mean(axis=0)
        pilot_off = preamble_length + SYS.cp_len
        data_off = pilot_off + SYS.n_fft + SYS.cp_len
        pilot_bins = np.asarray(ofdm_fft_used(
            jnp.asarray(combined[pilot_off:pilot_off + SYS.n_fft]), SYS,
        ))
        data_bins = np.asarray(ofdm_fft_used(
            jnp.asarray(combined[data_off:data_off + SYS.n_fft]), SYS,
        ))
        h_est = np.asarray(ls_channel_estimate(pilot_bins, pilot_used))
        eq = np.asarray(equalize(data_bins, jnp.asarray(h_est)))
        eq_aligned, gain = align_complex_gain(jnp.asarray(eq), data_used)
        gain = complex(
            np.asarray(jnp.real(gain)) + 1j * np.asarray(jnp.imag(gain))
        )
        evm_rms, evm_db = evm_rms_db(eq_aligned, jnp.asarray(data_used))
        evm_pct, evm_db = 100.0 * float(evm_rms), float(evm_db)
        frame_results.append(
            FrameResult(timing_err, float(cfo_err), evm_pct, evm_db)
        )
        print(f"  Frame {k}: start {int(starts[k])} (true {tstart}, "
              f"error {timing_err:+d}), CFO {cfo_est:.2f} Hz "
              f"(error {cfo_err:+.2f}), EVM {evm_pct:.2f}% "
              f"({evm_db:.2f} dB), gain {abs(gain):.3f}")
        if abs(timing_err) > SYS.cp_len:
            # the reference design doc's multipath group-delay offset
            # (+77..+94 samples, docs/aa_preamble_sync_design.md section 13)
            # exceeds this system's 72-sample CP: ISI degrades the EQ below
            print(f"    NOTE: timing error exceeds the {SYS.cp_len}-sample "
                  "CP (multipath group delay) -- expect ISI")

    first = frame_results[0]
    print(f"\n  Gate [{best.gate_start}, {best.gate_end}], peak metric "
          f"M={best.metric_at_peak:.3f}, events={len(result.events)}")
    print(report.BANNER)
    return FusedRxResult(
        True, first.timing_error, first.cfo_error_hz, first.evm_pct,
        first.evm_db, frames=frame_results,
    )


def run_fused_rx_minn_rtl(
    snr_db: float = 0.0,
    channel_name: str | None = None,
    cfo_hz: float = 1000.0,
    seed: int = 0,
) -> FusedRxResult:
    """FLAGSHIP receive chain: the Minn-RTL 30.72 MHz family end-to-end
    (`MinnRTLDetector.detect_frames`: the fused Triton kernel on a GPU).

    Two-frame stimulus (reference minn_rtl.py:884-889: [pad | frame |
    guard | frame]) -> detect -> device-side
    aligned frame re-emission (`ops.extract`; the output contract of
    ref/minn_preamble_detector.sv:445-530) -> per frame: CP-based CFO
    estimate on the pilot CP -> LS channel estimate from the pilot symbol
    -> equalize the data symbol -> EVM.  Frame windows open at the frame's
    S0 start (reference minn_rtl.py:943-953 geometry: RTL peak at
    s0 + 6Q).
    """
    from ofdm_sync_tpu.params import MinnRTLParams, SYS_30M72
    from ofdm_sync_tpu.models.detectors import MinnRTLDetector
    from ofdm_sync_tpu.ops.estimate import estimate_cfo_from_cp
    from ofdm_sync_tpu.ops.waveforms import build_minn_rtl_preamble
    from ofdm_sync_tpu.pipelines import common

    sys_p = SYS_30M72
    params = MinnRTLParams()
    Q = params.quarter_len
    fs = sys_p.sample_rate_hz
    rng = np.random.default_rng(seed)

    preamble = build_minn_rtl_preamble(
        params.seq_type, rng, Q=Q, sys=sys_p
    )
    setup = common.build_setup(
        preamble, rng, sys=sys_p, channel_name=channel_name,
        cir_mode="two", snr_db=snr_db, cfo_hz=cfo_hz, two_frames=True,
    )
    frame_len = setup.extras["frame_len"]
    # margin so the SECOND frame's window fits after channel group delay
    # (extract_frames clips windows into the stream)
    margin = sys_p.cp_len + 256
    rx = np.concatenate(
        [setup.rx, np.zeros((setup.rx.shape[0], margin), setup.rx.dtype)],
        axis=-1,
    )
    true_starts = [
        sys_p.tx_pre_pad + setup.channel_peak_offset,
        sys_p.tx_pre_pad + 2 * frame_len + setup.channel_peak_offset,
    ]

    det = MinnRTLDetector(sys_p, params)
    result, frames_dev, starts, valid = det.detect_frames(
        rx, frame_len=frame_len, max_frames=4,
    )

    channel_str = channel_name if channel_name else "awgn"
    report.banner(
        f"RECEIVE CHAIN - MINN-RTL Q={Q} (30.72 MHz), "
        f"{channel_str.upper()}, SNR {snr_db:+.0f} dB"
    )
    print(f"Stream: {rx.shape[1]} samples x {rx.shape[0]} branch(es), "
          f"2 frames sent, frame_len {frame_len}")
    if not valid.any():
        print("NO DETECTION -- receiver idle")
        return FusedRxResult(False, -1, float("nan"), float("nan"),
                             float("nan"))

    n_det = int(valid.sum())
    print(f"\nDetection (event table -> device-side frame "
          f"re-emission, {n_det} frame window(s)):")

    n_fft, cp = sys_p.n_fft, sys_p.cp_len
    pre_len = 5 * Q
    pilot_cp_off = pre_len                       # local frame layout
    pilot_n_off = pilot_cp_off + cp
    data_cp_off = pilot_n_off + n_fft
    data_n_off = data_cp_off + cp

    frame_results: list[FrameResult] = []
    for k in range(n_det):
        tstart = true_starts[k] if k < len(true_starts) else true_starts[-1]
        timing_err = int(starts[k]) - tstart
        fp = frames_dev[k]  # planar (2*BR, frame_len) float32
        ants = np.stack([
            fp[2 * b] + 1j * fp[2 * b + 1]
            for b in range(fp.shape[0] // 2)
        ])
        cfo_est = float(estimate_cfo_from_cp(
            jnp.asarray(ants, jnp.complex64), pilot_cp_off, n_fft, cp, fs
        ))
        cfo_err = cfo_est - cfo_hz
        ants_c = np.asarray(
            apply_cfo(jnp.asarray(ants, jnp.complex64), -cfo_est, fs)
        )
        combined = ants_c.mean(axis=0)
        pilot_bins = np.asarray(ofdm_fft_used(
            jnp.asarray(combined[pilot_n_off:pilot_n_off + n_fft]),
            sys_p,
        ))
        data_bins = np.asarray(ofdm_fft_used(
            jnp.asarray(combined[data_n_off:data_n_off + n_fft]), sys_p,
        ))
        h_est = np.asarray(
            ls_channel_estimate(pilot_bins, jnp.asarray(setup.pilot_used))
        )
        eq = np.asarray(equalize(data_bins, jnp.asarray(h_est)))
        eq_aligned, gain = align_complex_gain(
            jnp.asarray(eq), jnp.asarray(setup.data_used)
        )
        evm_rms, evm_db = evm_rms_db(
            eq_aligned, jnp.asarray(setup.data_used)
        )
        evm_pct, evm_db = 100.0 * float(evm_rms), float(evm_db)
        frame_results.append(
            FrameResult(timing_err, float(cfo_err), evm_pct, evm_db)
        )
        print(f"  Frame {k}: start {int(starts[k])} (true {tstart}, "
              f"error {timing_err:+d}), CFO {cfo_est:.2f} Hz "
              f"(error {cfo_err:+.2f}), EVM {evm_pct:.2f}% "
              f"({evm_db:.2f} dB)")

    if result.events:
        e0 = result.events[0]
        print(f"\n  Gate [{e0.gate_start}, {e0.gate_end}), peak metric "
              f"{e0.peak_value:.0f}, events={len(result.events)}")
    print(report.BANNER)
    first = frame_results[0]
    return FusedRxResult(
        True, first.timing_error, first.cfo_error_hz, first.evm_pct,
        first.evm_db, frames=frame_results,
    )


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--family", default="aa", choices=("aa", "minn_rtl"),
                    help="aa: 10 MHz [A][A] system; minn_rtl: the flagship "
                    "Minn-RTL 30.72 MHz family")
    ap.add_argument("--snr", type=float, default=None)
    ap.add_argument("--channel", default=None,
                    help="cir1 / cir2 / omit for AWGN")
    ap.add_argument("--cfo", type=float, default=None)
    ap.add_argument("--preamble-len", type=int, default=PREAMBLE_LEN)
    ap.add_argument("--num-frames", type=int, default=1)
    args = ap.parse_args(argv)
    if args.family == "minn_rtl":
        run_fused_rx_minn_rtl(
            snr_db=args.snr if args.snr is not None else 0.0,
            channel_name=args.channel,
            cfo_hz=args.cfo if args.cfo is not None else 1000.0,
        )
    else:
        run_fused_rx(
            snr_db=args.snr if args.snr is not None else SNR_DB,
            channel_name=args.channel,
            cfo_hz=args.cfo if args.cfo is not None else CFO_HZ,
            preamble_length=args.preamble_len,
            num_frames=args.num_frames,
        )


if __name__ == "__main__":
    main()
