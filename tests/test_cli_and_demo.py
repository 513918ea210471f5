"""CLI dispatcher, CP/FFT STO demo, and profiling utilities."""

import numpy as np
import jax.numpy as jnp

from ofdm_sync_tpu.__main__ import main as cli_main
from ofdm_sync_tpu.pipelines.cp_fft_demo import (
    EARLY_SAMPLES,
    LATE_SAMPLES,
    run_demo,
)
from ofdm_sync_tpu.utils.profiling import Throughput, kernel_stats


def test_cp_fft_demo_sto_estimates():
    """STO from phase slope, reference sign convention (reference
    ofdm_cp_fft_demo.py:95-105): a window starting d samples EARLY sees the
    symbol delayed by d -> STO estimate +d; a late window -> -d (its ISI from
    the next symbol's CP warrants a looser tolerance)."""
    res = run_demo(np.random.default_rng(7))
    assert abs(res.sto_est_early - EARLY_SAMPLES) < 0.5
    assert abs(res.sto_est_late - (-LATE_SAMPLES)) < 2.0


def test_cli_list(capsys):
    assert cli_main(["list"]) == 0
    out = capsys.readouterr().out
    for name in ("sc", "minn_rtl", "zc_v2", "aa", "cp_fft_demo"):
        assert name in out
    assert "MinnRTLDetector" in out


def test_cli_runs_demo(capsys):
    assert cli_main(["cp_fft_demo"]) == 0
    out = capsys.readouterr().out
    assert "STO estimate" in out


def test_cli_waveform(tmp_path, capsys):
    for kind in ("preamble", "frame", "aa_preamble"):
        assert cli_main(["waveform", kind, "--out", str(tmp_path)]) == 0
        assert (tmp_path / f"{kind}.png").exists()
    out = capsys.readouterr().out
    assert "PAPR 3.69 dB" in out  # documented [A][A] figure


def test_profiler_trace_context(tmp_path):
    from ofdm_sync_tpu.utils.profiling import trace

    with trace(str(tmp_path / "tr")):
        jnp.sum(jnp.ones((64, 64)) * 2).block_until_ready()
    # the profiler writes a plugins/profile/<run>/ tree
    produced = list((tmp_path / "tr").rglob("*"))
    assert produced, "no trace artifacts written"


def test_throughput_meter():
    x = jnp.ones((4, 256))
    stats = Throughput(samples_per_call=4 * 256, warmup=1).measure(
        lambda v: jnp.sum(v * 2), x, iters=3
    )
    assert stats["samples_per_sec"] > 0
    stats2 = kernel_stats(
        lambda v: jnp.sum(v), x, samples_per_call=4 * 256, iters=2,
        label="test",
    )
    assert stats2["iters"] == 2


def test_fused_rx_pipeline():
    """Receive chain: detection + CFO + EQ + EVM lands within physical
    expectations (SNR 10 dB, 2 antennas)."""
    from ofdm_sync_tpu.pipelines.fused_rx import run_fused_rx

    r = run_fused_rx()
    assert r.detected
    assert abs(r.timing_error) <= 16   # the RTL conformance precedent
    assert abs(r.cfo_error_hz) < 25.0  # design-doc AWGN bound (clipping bias)
    assert r.evm_pct < 35.0            # ~ sqrt(1/SNR) / sqrt(2 antennas)


def test_fused_rx_two_frames():
    """Multi-frame stimulus (reference minn_rtl.py:884-888 transmits two
    frames): ONE detection pass + device-side aligned re-emission
    (ref/minn_preamble_detector.sv:445-530) recovers and demodulates BOTH
    frames."""
    from ofdm_sync_tpu.pipelines.fused_rx import run_fused_rx

    r = run_fused_rx(snr_db=15.0, num_frames=2)
    assert r.detected
    assert len(r.frames) >= 2
    for fr in r.frames[:2]:
        assert abs(fr.timing_error) <= 16  # the RTL conformance precedent
        assert fr.evm_pct < 30.0


def test_fused_rx_cli():
    from ofdm_sync_tpu.__main__ import main

    assert main(["fused_rx", "--snr", "15"]) == 0


def test_fused_rx_minn_rtl_two_frames():
    """FLAGSHIP receive chain: the Minn-RTL 30.72 MHz family end-to-end --
    two-frame stimulus (reference minn_rtl.py:884-889), detect, device-side frame
    re-emission (ref/minn_preamble_detector.sv:445-530 output contract),
    CP-CFO + LS EQ + EVM per frame."""
    from ofdm_sync_tpu.pipelines.fused_rx import run_fused_rx_minn_rtl

    r = run_fused_rx_minn_rtl(snr_db=30.0, cfo_hz=1000.0)
    assert r.detected
    assert len(r.frames) == 2          # BOTH frames recovered
    for fr in r.frames:
        assert abs(fr.timing_error) <= 2   # AWGN: peak lands at s0 + 6Q
        assert abs(fr.cfo_error_hz) < 30.0
        assert fr.evm_pct < 6.0            # ~ noise floor at 30 dB SNR
