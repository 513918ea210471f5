"""[A][A] detector single tests + grid sweep (reference sync_aa.py:648-1123).

Two execution paths:
  * `run_single_test` / `run_grid_test`: faithful serial harness (same seeds,
    same prints) for parity with the reference.
  * `run_grid_test_batched`: the device path -- the whole SNR x full-scale
    grid for one channel/preamble-length executes as a single vmapped,
    jitted program with on-device noise (the reference's 135-config serial
    loop, reference sync_aa.py:829-899, becomes one launch).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from ofdm_sync_tpu.params import AADetectorParams, SYS_AA_10M
from ofdm_sync_tpu.models.detectors import AADetector
from ofdm_sync_tpu.ops.channel import (
    apply_cfo,
    apply_channel_multi_antenna,
    awgn_noise_device,
    compute_clipping_stats,
    load_measured_cir,
    quantize_adc,
)
from ofdm_sync_tpu.ops.waveforms import (
    AA_PREAMBLE_LENGTHS,
    assemble_frame,
    build_aa_preamble,
    build_aa_qpsk_symbol,
)
from ofdm_sync_tpu.utils import report

SYS = SYS_AA_10M
PLOTS_DIR = Path("plots") / "sync_aa"


@dataclass
class TestResult:
    """Per-config result (reference sync_aa.py:651-666)."""

    snr_db: float
    channel: str
    full_scale_ratio: float
    preamble_length: int
    timing_error: int
    cfo_applied_hz: float
    cfo_estimated_hz: float
    cfo_error_hz: float
    detected: bool
    num_events: int
    clipping_pct: float
    effective_bits: float
    metric_peak: float


def run_single_test(
    snr_db: float,
    channel_name: str | None,
    full_scale_ratio: float,
    preamble_length: int = 1024,
    cfo_hz: float = 500.0,
    seed: int = 42,
    plot: bool = False,
    plot_dir: Path | None = None,
) -> TestResult:
    """One sync test: frame -> channel -> CFO -> 12-bit ADC -> detect
    (reference sync_aa.py:669-823)."""
    rng = np.random.default_rng(seed)
    channel_str = channel_name if channel_name else "awgn"
    L = preamble_length // 2

    preamble, _, _ = build_aa_preamble(preamble_length, SYS)
    pilot_symbol, _ = build_aa_qpsk_symbol(rng, SYS)
    data_symbol, _ = build_aa_qpsk_symbol(rng, SYS)
    tx = assemble_frame(
        preamble, pilot_symbol, data_symbol, pre_pad=SYS.tx_pre_pad, post_pad=500
    )
    true_preamble_start = SYS.tx_pre_pad

    rx, cir, channel_peak_offset = apply_channel_multi_antenna(
        tx, snr_db, rng, channel_name, num_rx_antennas=2
    )
    true_preamble_start += channel_peak_offset
    rx = np.asarray(apply_cfo(jnp.asarray(rx, jnp.complex64), cfo_hz, SYS.sample_rate_hz))

    signal_rms = np.sqrt(np.mean(np.abs(rx) ** 2))
    full_scale = signal_rms * full_scale_ratio
    clip_stats = compute_clipping_stats(rx.flatten(), full_scale)
    rx_q = np.asarray(quantize_adc(jnp.asarray(rx, jnp.complex64), float(full_scale)))

    det = AADetector(SYS, AADetectorParams(preamble_len=preamble_length))
    state, result = det.detect(rx_q)

    best = AADetector.best(result)
    if best is not None:
        detected = True
        timing_error = best.detected_start - true_preamble_start
        cfo_estimated = best.cfo_hz
        cfo_error = cfo_estimated - cfo_hz
        metric_peak = best.metric_at_peak
        num_events = len(result.events)
    else:
        detected = False
        timing_error = 0
        cfo_estimated = 0.0
        cfo_error = cfo_hz
        metric_peak = (
            float(np.max(np.asarray(state.M))) if np.any(np.asarray(state.valid)) else 0.0
        )
        num_events = 0

    if plot and plot_dir is not None:
        plot_dir.mkdir(parents=True, exist_ok=True)
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(3, 1, figsize=(12, 9), sharex=True)
        rx_mag = np.sqrt(np.sum(np.abs(rx_q) ** 2, axis=0))
        axes[0].plot(rx_mag, alpha=0.7)
        axes[0].axvline(true_preamble_start, color="g", linestyle="--", label="True start")
        if detected:
            axes[0].axvline(best.detected_start, color="r", linestyle=":", label="Detected")
        axes[0].set_ylabel("|rx|")
        axes[0].set_title(
            f"{channel_str.upper()}, SNR={snr_db}dB, FS={full_scale_ratio}x, L={L}"
        )
        axes[0].legend()
        axes[0].grid(True, alpha=0.3)
        axes[1].plot(np.asarray(state.M), label="M[n]")
        axes[1].axhline(det.params.threshold, color="orange", linestyle="--", label="Threshold")
        expected_peak = true_preamble_start + 2 * L - 1
        axes[1].axvline(expected_peak, color="g", linestyle="--", label="Expected peak")
        if detected:
            axes[1].axvline(best.peak_index, color="r", linestyle=":")
            for evt in result.events:
                axes[1].axvspan(evt.gate_start, evt.gate_end, alpha=0.2, color="orange")
        axes[1].set_ylabel("Metric")
        axes[1].set_ylim(-0.1, 1.1)
        axes[1].legend()
        axes[1].grid(True, alpha=0.3)
        axes[2].plot(np.abs(np.asarray(state.P)) ** 2, label="|P|^2")
        axes[2].axvline(expected_peak, color="g", linestyle="--", label="Expected peak")
        if detected:
            axes[2].axvline(best.peak_index, color="r", linestyle=":", label="Detected peak")
        axes[2].set_ylabel("|P|^2")
        axes[2].set_xlabel("Sample")
        axes[2].legend()
        axes[2].grid(True, alpha=0.3)
        plt.tight_layout()
        plt.savefig(
            plot_dir / f"{channel_str}_snr{snr_db:+.0f}dB_fs{full_scale_ratio:.2f}_L{L}.png",
            dpi=120,
        )
        if preamble_length == 1024:
            # the reference tree carries the default-length condition under
            # BOTH namings (e.g. cir1_snr+10dB_fs1.00.png AND ..._L512.png,
            # reference plots/sync_aa/cir1/); emit both for artifact parity
            plt.savefig(
                plot_dir / f"{channel_str}_snr{snr_db:+.0f}dB_fs{full_scale_ratio:.2f}.png",
                dpi=120,
            )
        plt.close()

    return TestResult(
        snr_db=snr_db,
        channel=channel_str,
        full_scale_ratio=full_scale_ratio,
        preamble_length=preamble_length,
        timing_error=timing_error,
        cfo_applied_hz=cfo_hz,
        cfo_estimated_hz=cfo_estimated if detected else 0.0,
        cfo_error_hz=cfo_error,
        detected=detected,
        num_events=num_events,
        clipping_pct=clip_stats["total_clip_pct"],
        effective_bits=clip_stats["effective_bits"],
        metric_peak=metric_peak,
    )


def run_grid_test(
    snr_values=(-5, 0, 5, 10, 15),
    channels=(None, "cir1", "cir2"),
    full_scale_ratios=(0.25, 0.5, 1.0, 1.5, 2.0),
    preamble_lengths=AA_PREAMBLE_LENGTHS,
    cfo_hz: float = 500.0,
    plot_samples: bool = False,
) -> list[TestResult]:
    """Serial parity grid (reference sync_aa.py:829-899)."""
    results: list[TestResult] = []
    total = len(snr_values) * len(channels) * len(full_scale_ratios) * len(preamble_lengths)
    report.banner("[A][A] PREAMBLE SYNCHRONIZATION - GRID TEST")
    print(f"Total tests: {total}")
    test_num = 0
    for preamble_len in preamble_lengths:
        L = preamble_len // 2
        print(f"\n--- Preamble Length: {preamble_len} samples (L={L}) ---")
        for channel in channels:
            channel_str = channel if channel else "awgn"
            for snr_db in snr_values:
                for fs_ratio in full_scale_ratios:
                    test_num += 1
                    do_plot = plot_samples and fs_ratio == 1.0 and preamble_len == 1024
                    r = run_single_test(
                        snr_db=snr_db,
                        channel_name=channel,
                        full_scale_ratio=fs_ratio,
                        preamble_length=preamble_len,
                        cfo_hz=cfo_hz,
                        seed=42,
                        plot=do_plot,
                        plot_dir=PLOTS_DIR / channel_str,
                    )
                    results.append(r)
                    status = "OK " if r.detected else "MISS"
                    print(
                        f"[{test_num:3d}/{total}] L={L:3d} {channel_str:6s} "
                        f"SNR={snr_db:+3.0f}dB FS={fs_ratio:.2f}x -> {status} "
                        f"timing_err={r.timing_error:+4d} "
                        f"cfo_err={r.cfo_error_hz:+7.1f}Hz "
                        f"clip={r.clipping_pct:5.1f}%"
                    )
    return results


# ---------------------------------------------------------------------------
# Batched grid on the device (new capability)
# ---------------------------------------------------------------------------

_GRID_PARAMS = AADetectorParams()  # threshold / hysteresis shared by all paths


def _synth_config(noise_key, snr_db, fs_ratio, x, cfo_hz: float, fs_hz: float):
    """One grid cell's quantized stream (complex in, complex out, traced):
    on-device AWGN + CFO + 12-bit ADC, the shared stimulus of all grid
    paths (reference sync_aa.py:712-735)."""
    noise = awgn_noise_device(noise_key, x, snr_db)
    rx = apply_cfo(x + noise, cfo_hz, fs_hz)
    rms = jnp.sqrt(jnp.mean(jnp.abs(rx) ** 2))
    return quantize_adc(rx, rms * fs_ratio)


def _batched_single(rx_clean, noise_key, snr_db, fs_ratio, L: int, threshold: float,
                    hysteresis: int, fs_hz: float, cfo_hz: float):
    """One grid cell, fully on device.  vmapped over (snr, fs) configs."""
    rx_q = _synth_config(noise_key, snr_db, fs_ratio, rx_clean, cfo_hz, fs_hz)

    from ofdm_sync_tpu.ops.metrics import aa_metric
    from ofdm_sync_tpu.ops.detect import extract_gate_events

    state = aa_metric(rx_q, L)
    above = state.valid & (state.M >= threshold)
    track = jnp.abs(state.P) ** 2
    table = extract_gate_events(
        above, track, hysteresis=hysteresis, max_events=8, tie="first",
        emit_unclosed=True,
    )
    M_at_peak = state.M[table.peak_idx] * table.valid
    best = jnp.argmax(M_at_peak)
    peak_idx = table.peak_idx[best]
    P_peak = state.P[peak_idx]
    detected = table.count > 0
    cfo_est = jnp.angle(P_peak) * fs_hz / (2 * jnp.pi * L)
    frame_start = peak_idx - 2 * L + 1
    return {
        "detected": detected,
        "frame_start": frame_start,
        "cfo_est": cfo_est,
        "metric_peak": M_at_peak[best],
        "num_events": table.count,
    }


@functools.partial(jax.jit, static_argnames=("L", "fs_hz", "cfo_hz"))
def _xla_sweep(keys, snr_grid, fs_grid, rx_planar, *, L, fs_hz, cfo_hz):
    """Whole grid through the vmapped XLA detector (jitted once per
    (shape, L); complex math stays inside the compiled program)."""
    x = (rx_planar[..., 0, :] + 1j * rx_planar[..., 1, :]).astype(
        jnp.complex64
    )
    return jax.vmap(
        jax.vmap(
            lambda k, s, f: _batched_single(
                x, k, s, f, L,
                _GRID_PARAMS.threshold, _GRID_PARAMS.hysteresis,
                fs_hz, cfo_hz,
            )
        )
    )(keys, snr_grid, fs_grid)


def _grid_clean_stream(preamble_length: int, channel_name: str | None, seed: int):
    """Shared TX/channel synthesis for the grid sweeps.  Returns
    (rx_planar float32 (BR, 2, L), true_start, L)."""
    rng = np.random.default_rng(seed)
    L = preamble_length // 2
    preamble, _, _ = build_aa_preamble(preamble_length, SYS)
    pilot, _ = build_aa_qpsk_symbol(rng, SYS)
    data, _ = build_aa_qpsk_symbol(rng, SYS)
    tx = assemble_frame(preamble, pilot, data, pre_pad=SYS.tx_pre_pad,
                        post_pad=500)
    if channel_name is None:
        rx_clean = np.stack([tx, tx])
        peak_off = 0
    else:
        from ofdm_sync_tpu.ops.channel import (
            apply_cir,
            compute_channel_peak_offset,
        )

        cir = load_measured_cir(channel_name)[:2]
        rx_clean = np.asarray(apply_cir(tx, cir))
        peak_off = compute_channel_peak_offset(cir)
    rx_planar = np.stack(
        [rx_clean.real, rx_clean.imag], axis=-2
    ).astype(np.float32)
    return rx_planar, SYS.tx_pre_pad + peak_off, L


def _grid_keys(snr_values, full_scale_ratios, seed):
    snr = jnp.asarray(snr_values, jnp.float32)
    fs = jnp.asarray(full_scale_ratios, jnp.float32)
    snr_grid, fs_grid = jnp.meshgrid(snr, fs, indexing="ij")
    keys = jax.random.split(
        jax.random.key(seed), snr_grid.size
    ).reshape(snr_grid.shape)
    return keys, snr_grid, fs_grid


def _grid_outputs(out, shape, true_start, cfo_hz, snr_values,
                  full_scale_ratios):
    out = {k: np.asarray(v).reshape(shape) for k, v in out.items()}
    out["timing_error"] = out["frame_start"] - true_start
    out["cfo_error"] = out["cfo_est"] - cfo_hz
    out["snr_values"] = np.asarray(snr_values)
    out["full_scale_ratios"] = np.asarray(full_scale_ratios)
    return out


def run_grid_test_batched(
    preamble_length: int = 1024,
    channel_name: str | None = None,
    snr_values=(-5.0, 0.0, 5.0, 10.0, 15.0),
    full_scale_ratios=(0.25, 0.5, 1.0, 1.5, 2.0),
    cfo_hz: float = 500.0,
    seed: int = 42,
):
    """Entire (snr x full_scale) grid for one channel/preamble-length as ONE
    jitted, vmapped device program.  Returns dict of (n_snr, n_fs) arrays."""
    rx_planar, true_start, L = _grid_clean_stream(
        preamble_length, channel_name, seed
    )
    keys, snr_grid, fs_grid = _grid_keys(snr_values, full_scale_ratios, seed)
    out = _xla_sweep(
        keys, snr_grid, fs_grid, jnp.asarray(rx_planar),
        L=L, fs_hz=float(SYS.sample_rate_hz), cfo_hz=float(cfo_hz),
    )
    return _grid_outputs(out, snr_grid.shape, true_start, cfo_hz,
                         snr_values, full_scale_ratios)


# ---------------------------------------------------------------------------
# Reporting (reference sync_aa.py:902-1069)
# ---------------------------------------------------------------------------

def print_summary_table(results: list[TestResult]) -> None:
    report.banner("SUMMARY TABLE")
    preamble_lengths = sorted({r.preamble_length for r in results}, reverse=True)
    channels = sorted({r.channel for r in results})
    snr_values = sorted({r.snr_db for r in results})
    fs_ratios = sorted({r.full_scale_ratio for r in results})

    for plen in preamble_lengths:
        L = plen // 2
        report.banner(f"PREAMBLE LENGTH: {plen} samples (L={L})")
        for channel in channels:
            print(f"\n--- {channel.upper()} ---")
            print(f"{'SNR':>6s}", end="")
            for f in fs_ratios:
                print(f" | FS={f:.2f}", end="")
            print()
            print("-" * (8 + 10 * len(fs_ratios)))
            for snr in snr_values:
                print(f"{snr:+5.0f}dB", end="")
                for f in fs_ratios:
                    match = [
                        r for r in results
                        if r.channel == channel and r.snr_db == snr
                        and r.full_scale_ratio == f and r.preamble_length == plen
                    ]
                    if match:
                        r = match[0]
                        print(f" | {r.timing_error:+5d}" if r.detected else " |  MISS", end="")
                    else:
                        print(" |   N/A", end="")
                print()

    report.banner("DETECTION RATE BY PREAMBLE LENGTH AND CHANNEL")
    for plen in preamble_lengths:
        print(f"\nPreamble L={plen // 2}:")
        for channel in channels:
            rs = [r for r in results if r.channel == channel and r.preamble_length == plen]
            det = sum(1 for r in rs if r.detected)
            pct = 100 * det / len(rs) if rs else 0
            print(f"  {channel:6s}: {det}/{len(rs)} ({pct:.0f}%)")

    report.banner("TIMING ERROR STATISTICS BY PREAMBLE LENGTH (detected only)")
    for plen in preamble_lengths:
        rs = [r for r in results if r.detected and r.preamble_length == plen]
        if rs:
            errs = [r.timing_error for r in rs]
            print(f"\nPreamble L={plen // 2}:")
            print(f"  Mean:   {np.mean(errs):+.1f} samples")
            print(f"  Std:    {np.std(errs):.1f} samples")
            print(f"  Range:  [{np.min(errs):+d}, {np.max(errs):+d}]")
            within = sum(1 for e in errs if abs(e) <= SYS.cp_len)
            print(f"  Within CP ({SYS.cp_len}): {within}/{len(errs)}")

    report.banner("CFO ERROR STATISTICS BY PREAMBLE LENGTH (detected only)")
    for plen in preamble_lengths:
        rs = [r for r in results if r.detected and r.preamble_length == plen]
        if rs:
            errs = [r.cfo_error_hz for r in rs]
            print(f"\nPreamble L={plen // 2}:")
            print(f"  Mean:   {np.mean(errs):+.1f} Hz")
            print(f"  Std:    {np.std(errs):.1f} Hz")
            print(f"  Range:  [{np.min(errs):+.1f}, {np.max(errs):+.1f}] Hz")


def plot_heatmaps(results: list[TestResult]) -> None:
    """Success/fail + timing-error heatmaps per (preamble length, channel)
    (reference sync_aa.py:994-1069)."""
    import matplotlib.pyplot as plt

    preamble_lengths = sorted({r.preamble_length for r in results}, reverse=True)
    channels = sorted({r.channel for r in results})
    snr_values = sorted({r.snr_db for r in results})
    fs_ratios = sorted({r.full_scale_ratio for r in results})
    n_rows, n_cols = len(preamble_lengths), len(channels)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(6 * n_cols, 4 * n_rows))
    axes = np.atleast_2d(axes)
    for i, plen in enumerate(preamble_lengths):
        for j, channel in enumerate(channels):
            grid = np.full((len(snr_values), len(fs_ratios)), np.nan)
            for r in results:
                if r.preamble_length == plen and r.channel == channel:
                    si = snr_values.index(r.snr_db)
                    fi = fs_ratios.index(r.full_scale_ratio)
                    grid[si, fi] = abs(r.timing_error) if r.detected else np.nan
            ax = axes[i, j]
            im = ax.imshow(grid, aspect="auto", origin="lower", cmap="viridis")
            ax.set_xticks(range(len(fs_ratios)))
            ax.set_xticklabels([f"{f:.2f}" for f in fs_ratios])
            ax.set_yticks(range(len(snr_values)))
            ax.set_yticklabels([f"{s:+.0f}" for s in snr_values])
            ax.set_xlabel("Full-scale ratio")
            ax.set_ylabel("SNR (dB)")
            ax.set_title(f"L={plen // 2}, {channel} (|timing err|, blank=miss)")
            fig.colorbar(im, ax=ax)
    PLOTS_DIR.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(PLOTS_DIR / "detection_heatmap.png", dpi=120)
    plt.close(fig)


def plot_preamble_design() -> None:
    """Time/spectrum/autocorrelation views of the three [A][A] preamble
    lengths (reference sync_aa.py's preamble_design.png artifact)."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(
        3, len(AA_PREAMBLE_LENGTHS), figsize=(5 * len(AA_PREAMBLE_LENGTHS), 9)
    )
    for j, total in enumerate(AA_PREAMBLE_LENGTHS):
        pre, _, papr = build_aa_preamble(total, SYS)
        L = total // 2
        axes[0, j].plot(np.abs(pre), linewidth=0.7)
        axes[0, j].set_title(f"L={L}: |x(t)|, PAPR {papr:.2f} dB")
        spec = np.fft.fftshift(np.abs(np.fft.fft(pre, SYS.n_fft)))
        axes[1, j].plot(spec, linewidth=0.7)
        axes[1, j].set_title("Spectrum magnitude")
        lag = np.correlate(pre, pre, mode="full")
        axes[2, j].plot(
            np.arange(-total + 1, total), np.abs(lag) / np.abs(lag).max(),
            linewidth=0.7,
        )
        axes[2, j].set_title("Autocorrelation (note the lag-L [A][A] peak)")
        for ax in axes[:, j]:
            ax.grid(True, alpha=0.4)
    PLOTS_DIR.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(PLOTS_DIR / "preamble_design.png", dpi=110)
    plt.close(fig)


def plot_metric_zoom_no_noise(total_length: int = 1024) -> None:
    """Noise-free metric around the plateau: M, |P|^2 and the peak position
    (reference sync_aa.py's metric_zoom_no_noise.png artifact, illustrating
    why the peak tracks |P|^2 rather than the flat-topped M)."""
    import matplotlib.pyplot as plt
    import jax.numpy as jnp
    from ofdm_sync_tpu.ops.metrics import aa_metric

    L = total_length // 2
    pre, _, _ = build_aa_preamble(total_length, SYS)
    sig = np.concatenate(
        [np.zeros(SYS.tx_pre_pad), pre, np.zeros(2 * L)]
    ).astype(complex)
    st = aa_metric(jnp.asarray(sig, jnp.complex64), L)
    M = np.asarray(st.M)
    p_sq = np.abs(np.asarray(st.P)) ** 2
    peak = int(np.argmax(p_sq))
    lo, hi = max(0, peak - 3 * L), min(M.size, peak + 2 * L)
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(11, 7), sharex=True)
    a1.plot(range(lo, hi), M[lo:hi], linewidth=0.9)
    a1.axvline(peak, linestyle="--", linewidth=0.8, color="tab:red")
    a1.set_ylabel("M = |P|^2 / R^2")
    a1.set_title(f"Noise-free metric zoom, L={L} (plateau top is flat)")
    a1.grid(True, alpha=0.4)
    a2.plot(range(lo, hi), p_sq[lo:hi] / p_sq[peak], linewidth=0.9,
            color="tab:orange")
    a2.axvline(peak, linestyle="--", linewidth=0.8, color="tab:red",
               label=f"peak @ {peak} -> frame start {peak - 2 * L + 1}")
    a2.set_ylabel("|P|^2 (normalized)")
    a2.set_xlabel("Sample offset")
    a2.grid(True, alpha=0.4)
    a2.legend()
    PLOTS_DIR.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(PLOTS_DIR / "metric_zoom_no_noise.png", dpi=110)
    plt.close(fig)


def plot_plateau_vs_peak(total_length: int = 1024) -> None:
    """Why the detector peaks on |P|^2 instead of ending the M plateau:
    with a pilot symbol following the preamble, the M plateau's trailing
    edge is dragged out by pilot correlation, while the |P|^2 peak stays put
    (reference sync_aa.py's plateau_vs_peak/plateau_vs_pilot artifacts)."""
    import matplotlib.pyplot as plt
    import jax.numpy as jnp
    from ofdm_sync_tpu.ops.metrics import aa_metric

    L = total_length // 2
    rng = np.random.default_rng(0)
    pre, _, _ = build_aa_preamble(total_length, SYS)
    pilot, _ = build_aa_qpsk_symbol(rng, SYS)
    fig, axes = plt.subplots(2, 1, figsize=(11, 7), sharex=True)
    for ax, (label, tail) in zip(
        axes,
        [("preamble then silence", np.zeros(2 * L, complex)),
         ("preamble then pilot symbol", pilot[: 2 * L])],
    ):
        sig = np.concatenate([np.zeros(SYS.tx_pre_pad), pre, tail]).astype(
            complex
        )
        st = aa_metric(jnp.asarray(sig, jnp.complex64), L)
        M = np.asarray(st.M)
        p_sq = np.abs(np.asarray(st.P)) ** 2
        peak = int(np.argmax(p_sq))
        ax.plot(M, linewidth=0.8, label="M")
        ax.plot(p_sq / max(p_sq.max(), 1e-12), linewidth=0.8,
                label="|P|^2 (norm)")
        ax.axvline(peak, linestyle="--", linewidth=0.8, color="tab:red",
                   label=f"|P|^2 peak @ {peak}")
        ax.set_title(label)
        ax.grid(True, alpha=0.4)
        ax.legend()
    axes[1].set_xlabel("Sample offset")
    PLOTS_DIR.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(PLOTS_DIR / "plateau_vs_peak_comparison.png", dpi=110)
    plt.close(fig)


def main() -> None:
    report.banner("[A][A] PREAMBLE SYNC - PAPR REPORT")
    for total in AA_PREAMBLE_LENGTHS:
        pre, _, papr = build_aa_preamble(total, SYS)
        half = total // 2
        corr = np.vdot(pre[:half], pre[half:]).real / half
        print(f"L={half}: PAPR={papr:.2f} dB, [A][A] corr={corr:.3f}")
    plot_preamble_design()
    plot_metric_zoom_no_noise()
    plot_plateau_vs_peak()
    results = run_grid_test()
    print_summary_table(results)
    plot_heatmaps(results)


if __name__ == "__main__":
    main()
