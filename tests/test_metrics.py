"""Vectorized f32 metrics vs. float64 loop oracles (conformance.golden)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ofdm_sync_tpu.ops import metrics as M
from ofdm_sync_tpu.conformance import golden as G

N = 256  # small FFT size keeps oracles fast; math is size-generic


def _rx(rng, branches=2, L=1200):
    x = rng.standard_normal((branches, L)) + 1j * rng.standard_normal((branches, L))
    return x.astype(np.complex128)


def _with_preamble(rng, preamble, branches=2, pad=300, snr=10.0):
    L = pad + preamble.size + 600
    x = np.zeros((branches, L), complex)
    x[:, pad : pad + preamble.size] = preamble
    noise_std = np.sqrt(10 ** (-snr / 10) / 2)
    x += noise_std * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x


def test_sc_metric_matches_oracle(rng):
    x = _rx(rng)
    got_M, got_P, got_R = M.sc_metric(jnp.asarray(x, jnp.complex64), N)
    want_M, want_P, want_R = G.golden_sc(x, N)
    np.testing.assert_allclose(np.asarray(got_P), want_P, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got_R), want_R, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(got_M), want_M, rtol=5e-3, atol=1e-5)


def test_minn_metric_matches_oracle(rng):
    x = _rx(rng)
    got_M, got_P, got_R = M.minn_metric(jnp.asarray(x, jnp.complex64), N)
    want_M, want_P, want_R = G.golden_minn(x, N)
    np.testing.assert_allclose(np.asarray(got_P), want_P, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got_R), want_R, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(got_M), want_M, rtol=5e-3, atol=1e-5)


def test_sc_generic_metric_matches_oracle(rng):
    x = _rx(rng, L=900)
    got_M, got_P, got_R = M.sc_generic_metric(jnp.asarray(x, jnp.complex64), 128)
    want_M, want_P, want_R = G.golden_sc_generic(x, 128)
    np.testing.assert_allclose(np.asarray(got_P), want_P, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got_M), want_M, rtol=5e-3, atol=1e-5)


def test_park_metric_matches_oracle(rng):
    x = _rx(rng, L=800)
    ds, got_M, got_P, got_E = M.park_metric(jnp.asarray(x, jnp.complex64), N)
    want_ds, want_M, want_P, want_E = G.golden_park(x, N)
    np.testing.assert_array_equal(np.asarray(ds), want_ds)
    np.testing.assert_allclose(np.asarray(got_P), want_P, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got_E), want_E, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(got_M), want_M, rtol=5e-3, atol=1e-6)


@pytest.mark.parametrize("half", [8, 128, 1024])
def test_park_banded_selfconv_exact(rng, half):
    """Banded-FFT self-convolution == the direct centered sum, at full
    reference scale (half=1024) and including block-boundary centers."""
    L = max(4 * half + 37, 5000)
    x = (rng.standard_normal(L) + 1j * rng.standard_normal(L)).astype(np.complex64)
    got = np.asarray(M.park_banded_selfconv(jnp.asarray(x), half))
    k = np.arange(half)
    scale = np.abs(x).max() ** 2 * half
    for d in list(range(half, half + 3)) + [2 * half - 1, 2 * half, 3 * half + 5,
                                            L - half - 1]:
        want = np.sum(x[d - k] * x[d + k])
        assert abs(got[d] - want) < 1e-5 * scale, d


@pytest.mark.slow
def test_park_banded_selfconv_batched(rng):
    """Leading batch axes broadcast through the banded path (the batched
    grid-sweep form)."""
    B, L, half = 3, 2000, 64
    x = (rng.standard_normal((B, 2, L)) + 1j * rng.standard_normal((B, 2, L))
         ).astype(np.complex64)
    got = np.asarray(M.park_banded_selfconv(jnp.asarray(x), half))
    assert got.shape == (B, 2, L)
    one = np.asarray(M.park_banded_selfconv(jnp.asarray(x[1, 0]), half))
    np.testing.assert_allclose(got[1, 0], one, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("branches", [1, 2])
def test_minn_rtl_metric_matches_oracle(rng, branches):
    Q = 64
    x = _rx(rng, branches=branches, L=1000)
    got = M.minn_rtl_metric(
        jnp.asarray(x, jnp.complex64),
        smooth_shift=3,
        threshold_value=3276,
        threshold_frac_bits=15,
        quarter_len=Q,
    )
    want = G.golden_minn_rtl_metric(x, Q, 3, 3276, 15)
    np.testing.assert_allclose(
        np.asarray(got.corr_total), want["corr_total"], rtol=1e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(got.energy_total), want["energy_total"], rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.smooth_metric), want["smooth"], rtol=2e-3, atol=2e-3
    )
    np.testing.assert_array_equal(np.asarray(got.metric_valid), want["valid"])
    # threshold flags may flip only at near-exact equality crossings
    assert np.mean(np.asarray(got.above_threshold) != want["above"]) < 0.01


def test_aa_metric_matches_oracle(rng):
    L = 64
    x = _rx(rng, branches=2, L=700)
    got = M.aa_metric(jnp.asarray(x, jnp.complex64), L)
    want_P, want_R, want_M, want_valid = G.golden_aa(x, L)
    np.testing.assert_allclose(np.asarray(got.P), want_P, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got.R), want_R, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.M), want_M, rtol=5e-3, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got.valid), want_valid)


def test_sc_detects_its_preamble(rng):
    """End-to-end sanity: the S&C metric plateaus on an [A][A] preamble."""
    from ofdm_sync_tpu.ops.waveforms import build_sc_preamble
    from ofdm_sync_tpu.params import SystemParams

    sys = SystemParams(n_fft=N, num_active=180, cp_len=64, tx_pre_pad=0)
    pre = build_sc_preamble(rng, sys, include_cp=True)
    x = _with_preamble(rng, pre, snr=20.0)
    m, _, _ = M.sc_metric(jnp.asarray(x, jnp.complex64), N)
    m = np.asarray(m)
    # plateau spans [pad, pad+cp]; peak region must be inside
    peak = int(np.argmax(m))
    assert 300 - 8 <= peak <= 300 + 64 + 8
    assert m[peak] > 0.5


def test_minn_detects_its_preamble(rng):
    from ofdm_sync_tpu.ops.waveforms import (
        build_minn_preamble,
        build_random_qpsk_symbol,
        assemble_frame,
    )
    from ofdm_sync_tpu.params import SystemParams

    sys = SystemParams(n_fft=N, num_active=180, cp_len=64, tx_pre_pad=0)
    pre = build_minn_preamble(rng, sys, include_cp=True)
    pilot, _ = build_random_qpsk_symbol(rng, sys)
    data, _ = build_random_qpsk_symbol(rng, sys)
    frame = assemble_frame(pre, pilot, data, pre_pad=300)
    x = _with_preamble(rng, frame[300:], snr=20.0)
    m, _, _ = M.minn_metric(jnp.asarray(x, jnp.complex64), N)
    peak, gate, ms = M.find_minn_peak_standard(m, smooth_win=16, gate_threshold=0.5)
    # Minn peak aligns with symbol start = pad + cp (smoothing lags a little)
    assert abs(int(peak) - (300 + 64)) <= 16


def test_zc_matched_filter_peak(rng):
    from ofdm_sync_tpu.ops.waveforms import build_pss_symbol
    from ofdm_sync_tpu.params import SystemParams

    sys = SystemParams(n_fft=N, num_active=180, cp_len=64, tx_pre_pad=0)
    ref = build_pss_symbol(sys, include_cp=False)
    x = _with_preamble(rng, ref, snr=10.0)
    corr, mag = M.zc_normalized_correlation(jnp.asarray(x, jnp.complex64), jnp.asarray(ref, jnp.complex64))
    peak = int(np.argmax(np.asarray(mag)))
    # matched-filter peak lands at start + len(ref) - 1  (reference zc.py:130)
    assert abs(peak - (300 + ref.size - 1)) <= 2


def test_zc_freq_metric_peak(rng):
    from ofdm_sync_tpu.ops.waveforms import (
        build_pss_symbol,
        centered_subcarrier_indices,
        generate_zadoff_chu,
    )
    from ofdm_sync_tpu.params import SystemParams

    sys = SystemParams(n_fft=N, num_active=180, cp_len=64, tx_pre_pad=0)
    sym = build_pss_symbol(sys, include_cp=True)
    x = _with_preamble(rng, sym, snr=15.0)
    metric = M.zc_freq_metric(
        jnp.asarray(x, jnp.complex64),
        jnp.asarray(generate_zadoff_chu(25, 62)),
        centered_subcarrier_indices(62),
        n_fft=N,
        cp_len=64,
        chunk=128,
    )
    peak = int(np.argmax(np.asarray(metric)))
    assert abs(peak - 300) <= 4
    # value-level check against a direct per-offset NumPy computation
    # (an argmax-only assertion once let a per-chunk-energy reduction bug
    # through; see r2 review)
    tmpl = np.asarray(generate_zadoff_chu(25, 62))
    positions = (N // 2 + np.asarray(centered_subcarrier_indices(62))) % N
    for off in (peak - 40, peak, peak + 77):
        corr = 0.0
        energy = 0.0
        for b in range(x.shape[0]):
            win = np.asarray(x)[b, off + 64 : off + 64 + N]
            binv = np.fft.fftshift(np.fft.fft(win))[positions]
            corr += np.sum(np.conj(tmpl) * binv)
            energy += np.sum(np.abs(binv) ** 2)
        want = abs(corr) ** 2 / max(np.sum(np.abs(tmpl) ** 2) * energy, 1e-12)
        np.testing.assert_allclose(
            np.asarray(metric)[off], want, rtol=2e-3, err_msg=str(off)
        )


def test_zc_freq_metric_sliding_matches_fft(rng):
    """The sliding-DFT form == the chunked-FFT form (values, not
    just the peak)."""
    from ofdm_sync_tpu.ops.waveforms import (
        build_pss_symbol,
        centered_subcarrier_indices,
        generate_zadoff_chu,
    )
    from ofdm_sync_tpu.params import SystemParams

    sys = SystemParams(n_fft=N, num_active=180, cp_len=64, tx_pre_pad=0)
    sym = build_pss_symbol(sys, include_cp=True)
    x = _with_preamble(rng, sym, snr=15.0)
    args = (
        jnp.asarray(x, jnp.complex64),
        jnp.asarray(generate_zadoff_chu(25, 62)),
        centered_subcarrier_indices(62),
    )
    m_fft = np.asarray(M.zc_freq_metric(*args, n_fft=N, cp_len=64, chunk=128))
    m_sl = np.asarray(M.zc_freq_metric_sliding(*args, n_fft=N, cp_len=64))
    assert m_sl.shape == m_fft.shape
    assert int(m_sl.argmax()) == int(m_fft.argmax())
    np.testing.assert_allclose(
        m_sl, m_fft, atol=2e-4 * max(1.0, m_fft.max()), rtol=2e-3
    )


def test_zc_freq_detector_sliding_form(rng):
    from ofdm_sync_tpu.models.detectors import ZCFreqDetector
    from ofdm_sync_tpu.params import SystemParams, ZCParams

    sp = SystemParams(n_fft=N, num_active=180, cp_len=64, tx_pre_pad=0)
    from ofdm_sync_tpu.ops.waveforms import build_pss_symbol

    sym = build_pss_symbol(sp, include_cp=True)
    x = _with_preamble(rng, sym, snr=15.0)
    a = ZCFreqDetector(sys=sp, params=ZCParams()).detect(
        jnp.asarray(x, jnp.complex64)
    )
    b = ZCFreqDetector(sys=sp, params=ZCParams(), form="sliding").detect(
        jnp.asarray(x, jnp.complex64)
    )
    assert a["detected_cp_start"] == b["detected_cp_start"]


def test_zc_freq_sliding_long_stream_phase_exact(rng):
    """Streams past ~1M samples: the integer phase reduction must not wrap
    int32 (r2 review: k*n_idx overflowed for high template bins; indices
    are now reduced mod N before the multiply)."""
    n_fft, cp = 2048, 144
    L = 1_200_000
    x = (0.1 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
         ).astype(np.complex64)
    bins = np.array([-1023, -500, 500, 1023])  # high |k| -> worst products
    tmpl = (rng.standard_normal(4) + 1j * rng.standard_normal(4)
            ).astype(np.complex64)
    m = np.asarray(M.zc_freq_metric_sliding(
        jnp.asarray(x), jnp.asarray(tmpl), bins, n_fft, cp
    ))
    # direct per-offset DFT checks at tail offsets (where the old k*n
    # products exceeded 2^31)
    positions = (n_fft // 2 + bins) % n_fft
    e_t = float(np.sum(np.abs(tmpl) ** 2))
    for off in (L - n_fft - cp - 1, L - n_fft - cp - 12345):
        win = x[off + cp : off + cp + n_fft]
        binv = np.fft.fftshift(np.fft.fft(win))[positions]
        corr = np.sum(np.conj(tmpl) * binv)
        want = abs(corr) ** 2 / max(e_t * np.sum(np.abs(binv) ** 2), 1e-12)
        np.testing.assert_allclose(m[off], want, rtol=5e-2, atol=1e-7,
                                   err_msg=str(off))
