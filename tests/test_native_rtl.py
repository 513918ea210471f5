"""Native C++ integer detector vs the NumPy golden model and the fused kernel.

Mirrors the reference's verification triangle (ref/test_minn_preamble_detector
.py): RTL (here: the C++ bit-accurate model) vs vectorized golden model vs
float pipeline, with the reference's +-16 sample frame-start tolerance.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ofdm_sync_tpu.conformance.golden import (
    golden_gate_events,
    golden_minn_rtl_metric,
)
from ofdm_sync_tpu.kernels.minn_rtl_triton import minn_rtl_detect_triton
from ofdm_sync_tpu.kernels.streaming import to_planar
from ofdm_sync_tpu.native import minn_rtl_detect_native
from ofdm_sync_tpu.ops.channel import quantize_int
from ofdm_sync_tpu.ops.waveforms import build_minn_rtl_preamble

Q = 64
KW = dict(smooth_shift=3, threshold_value=3276, threshold_frac_bits=15)


def _stimulus(rng, snr_db=10.0, L=4000, pos=900):
    pre = build_minn_rtl_preamble("qpsk_freq", rng=np.random.default_rng(0), Q=Q)
    sig = np.zeros(L, complex)
    sig[pos : pos + 5 * Q] = pre
    rx = np.stack([sig, 0.8 * sig])
    noise_pow = np.mean(np.abs(pre) ** 2) / (10 ** (snr_db / 10))
    rx = rx + np.sqrt(noise_pow / 2) * (
        rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape)
    )
    re, im, _scale = quantize_int(rx, 12)
    return np.stack([re, im], axis=1).astype(np.int16)  # (2, 2, L)


def test_native_traces_match_golden_model(rng):
    """Integer corr/energy traces == the float golden model run on the same
    integer samples (exact below 2^53); smoothing within shift rounding."""
    iq = _stimulus(rng)
    det = minn_rtl_detect_native(
        iq, quarter_len=Q, **{
            "smooth_shift": 3, "threshold_value": 3276,
            "threshold_frac_bits": 15,
        },
        return_traces=True,
    )
    x = (iq[:, 0, :] + 1j * iq[:, 1, :]).astype(complex)
    g = golden_minn_rtl_metric(
        x, Q, smooth_shift=3, threshold_value=3276, frac_bits=15
    )
    np.testing.assert_array_equal(det.corr_total, g["corr_total"].astype(np.int64))
    np.testing.assert_array_equal(
        det.energy_total, g["energy_total"].astype(np.int64)
    )
    # integer arithmetic-shift smoothing stalls within 2^shift of the float
    # EMA fixpoint, so the absolute drift is bounded by 2^shift
    assert np.max(np.abs(det.smooth - g["smooth"])) <= (1 << 3)
    # threshold flags may differ only at gate edges (here: none at 10 dB)
    assert np.mean(det.above.astype(bool) != g["above"]) < 1e-3


def test_native_fsm_matches_golden_fsm(rng):
    """The C++ gate/hysteresis/peak FSM replayed on its own above/track
    traces must equal the sequential Python oracle exactly."""
    iq = _stimulus(rng, snr_db=0.0)
    det = minn_rtl_detect_native(
        iq, quarter_len=Q, hysteresis=2, return_traces=True, max_events=16
    )
    track = np.maximum(det.corr_total, 0).astype(float)
    events = golden_gate_events(
        det.above.astype(bool), track, hysteresis=2, tie="last",
        emit_unclosed=False,
    )
    assert len(events) == det.count
    for k, (start, close, peak_i, peak_v, closed) in enumerate(events):
        assert det.gate_start[k] == start
        assert det.gate_close[k] == close
        assert det.peak_idx[k] == peak_i
        assert det.peak_value[k] == pytest.approx(peak_v)
        assert bool(det.closed[k]) == closed


def test_native_vs_kernel_frame_start(rng):
    """Native int12 detector and the float fused kernel agree on the frame
    start within the reference's +-16-sample RTL tolerance
    (ref/test_minn_preamble_detector.py:446-451)."""
    iq_int = _stimulus(rng, snr_db=10.0)
    det = minn_rtl_detect_native(iq_int, quarter_len=Q, hysteresis=2)
    assert det.count >= 1

    x = (iq_int[:, 0, :] + 1j * iq_int[:, 1, :]).astype(complex)
    iq_f = to_planar(jnp.asarray(x)).reshape(4, -1)[:, None]
    table = minn_rtl_detect_triton(
        iq_f, quarter_len=Q, **KW, hysteresis=2, interpret=True
    )
    assert int(table.count[0]) >= 1
    native_peak = int(det.peak_idx[0])
    kernel_peak = int(np.asarray(table.peak_idx)[0, 0])
    assert abs(native_peak - kernel_peak) <= 16
    # expected peak: 1Q after preamble end (reference minn_rtl.py:60-106)
    expected = 900 + 5 * Q + Q - 1
    assert abs(native_peak - expected) <= 16


def test_native_overflow_and_unclosed(rng):
    """Capacity overflow reporting and the emit_unclosed tail event."""
    iq = np.zeros((1, 2, 200), np.int16)
    iq[0, 0, :] = 100  # constant DC: always above once valid -> one open gate
    det = minn_rtl_detect_native(
        iq, quarter_len=4, hysteresis=1, emit_unclosed=True, max_events=4
    )
    assert det.count == 1 and not det.closed[0]
    det2 = minn_rtl_detect_native(
        iq, quarter_len=4, hysteresis=1, emit_unclosed=False, max_events=4
    )
    assert det2.count == 0
