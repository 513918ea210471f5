import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ofdm_sync_tpu.kernels.streaming import (
    aa_metric_planar,
    from_planar,
    minn_rtl_detect_planar,
    minn_rtl_metric_planar,
    to_planar,
)
from ofdm_sync_tpu.ops import metrics as M
from ofdm_sync_tpu.ops import detect as M_detect


def _x(rng, branches=2, L=2048):
    return (
        rng.standard_normal((branches, L)) + 1j * rng.standard_normal((branches, L))
    ).astype(np.complex64)


def _assert_tables_equal(ref, out):
    """GateEvents equality within +-0 slots (peak_value up to f32 rounding)."""
    for f in ("valid", "closed", "gate_start", "gate_close", "peak_idx",
              "count", "overflow"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out, f)), np.asarray(getattr(ref, f)), err_msg=f
        )
    rv, ov = np.asarray(ref.peak_value), np.asarray(out.peak_value)
    np.testing.assert_allclose(ov, rv, atol=1e-4 * max(1.0, np.abs(rv).max()))


def _event_stimulus(rng, L=8192, Q=64, branches=2):
    """Noise stream with four preamble insertions at descending SNR, the last
    barely above the 0.1 fixed-point threshold -- threshold-straddling but
    with crossing margins far above f32 ulp, so all kernel paths must agree
    at EVENT granularity even where individual above-bits could flip."""
    x = 0.3 * (
        rng.standard_normal((branches, L)) + 1j * rng.standard_normal((branches, L))
    )
    A = rng.standard_normal(Q) + 1j * rng.standard_normal(Q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    for k, amp in enumerate([1.2, 0.8, 0.5, 0.35]):
        p = 600 + 1800 * k
        x[:, p : p + 5 * Q] += amp * pre
    return x.astype(np.complex64)


def test_planar_roundtrip(rng):
    x = _x(rng)
    p = to_planar(jnp.asarray(x))
    assert p.shape == (2, 2, 2048) and p.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(from_planar(p)), x, atol=1e-6)


def test_minn_rtl_planar_matches_complex(rng):
    x = _x(rng)
    ref = M.minn_rtl_metric(
        jnp.asarray(x), smooth_shift=3, threshold_value=3276,
        threshold_frac_bits=15, quarter_len=64,
    )
    fast = minn_rtl_metric_planar(
        to_planar(jnp.asarray(x)), quarter_len=64, smooth_shift=3,
        threshold_value=3276, threshold_frac_bits=15,
    )
    np.testing.assert_allclose(
        np.asarray(fast.corr_positive), np.asarray(ref.corr_positive),
        rtol=1e-5, atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(fast.energy_total), np.asarray(ref.energy_total),
        rtol=1e-5, atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(fast.smooth_metric), np.asarray(ref.smooth_metric),
        rtol=1e-4, atol=1e-3,
    )
    # Event-table equality (not a bit-rate tolerance): sub-ulp f32
    # reassociation may flip individual above-threshold bits right at the
    # threshold, but it must never create, destroy, or move a gate EVENT.
    ref_tab = M_detect.extract_gate_events(
        ref.above_threshold, ref.corr_positive, hysteresis=2, max_events=8,
        valid_from=3 * 64 - 1, tie="last", emit_unclosed=False,
    )
    fast_tab = M_detect.extract_gate_events(
        fast.above_threshold, fast.corr_positive, hysteresis=2, max_events=8,
        valid_from=fast.valid_from, tie="last", emit_unclosed=False,
    )
    _assert_tables_equal(ref_tab, fast_tab)


def test_minn_rtl_detect_planar_events(rng):
    from ofdm_sync_tpu.ops.waveforms import build_minn_rtl_preamble
    from ofdm_sync_tpu.params import SystemParams

    sys = SystemParams(n_fft=256, num_active=180, cp_len=64, tx_pre_pad=300)
    pre = build_minn_rtl_preamble("qpsk_freq", rng, Q=64, sys=sys)
    tx = np.zeros(2048, complex)
    tx[300 : 300 + pre.size] = pre
    tx[620:1400] = 0.4 * (rng.standard_normal(780) + 1j * rng.standard_normal(780))
    x = (np.stack([tx, tx]) + 0.05 * (
        rng.standard_normal((2, 2048)) + 1j * rng.standard_normal((2, 2048))
    )).astype(np.complex64)
    state, table = minn_rtl_detect_planar(
        to_planar(jnp.asarray(x)), quarter_len=64, smooth_shift=3,
        threshold_value=3276, threshold_frac_bits=15, hysteresis=2,
    )
    assert int(table.count) >= 1
    # peak should land near preamble end + Q (pilot-N-start convention)
    peak = int(table.peak_idx[0])
    assert abs(peak - (300 + 5 * 64 + 64)) <= 16


@pytest.mark.slow
def test_minn_rtl_planar_vmap(rng):
    """The fast path vmaps over a stream batch (the bench configuration)."""
    B = 4
    x = np.stack([_x(rng, L=1024) for _ in range(B)])
    iq = to_planar(jnp.asarray(x))  # (B, 2ant, 2, L)
    fn = jax.vmap(
        lambda s: minn_rtl_metric_planar(
            s, quarter_len=64, smooth_shift=3, threshold_value=3276,
            threshold_frac_bits=15,
        ).smooth_metric
    )
    out = fn(iq)
    assert out.shape == (B, 1024)
    single = minn_rtl_metric_planar(
        iq[1], quarter_len=64, smooth_shift=3, threshold_value=3276,
        threshold_frac_bits=15,
    ).smooth_metric
    np.testing.assert_allclose(np.asarray(out[1]), np.asarray(single), rtol=1e-6)


def test_event_tables_agree_across_all_paths(rng):
    """GateEvents from the complex-XLA, planar-XLA, and fused-kernel paths
    (Triton kernel in the Pallas interpreter) are identical
    (count/start/close/peak within +-0) on a threshold-straddling
    multi-event stimulus: bit-rate tolerances could hide an event-level
    divergence; tables cannot."""
    from ofdm_sync_tpu.kernels.minn_rtl_triton import minn_rtl_detect_triton

    Q, h, E = 64, 2, 8
    x = _event_stimulus(rng, L=8192, Q=Q)
    kw = dict(smooth_shift=3, threshold_value=3276, threshold_frac_bits=15)

    cplx = M.minn_rtl_metric(jnp.asarray(x), quarter_len=Q, **kw)
    t_cplx = M_detect.extract_gate_events(
        cplx.above_threshold, cplx.corr_positive, hysteresis=h, max_events=E,
        valid_from=3 * Q - 1, tie="last", emit_unclosed=False,
    )

    _, t_planar = minn_rtl_detect_planar(
        to_planar(jnp.asarray(x)), quarter_len=Q, hysteresis=h, max_events=E,
        **kw,
    )

    planar = to_planar(jnp.asarray(x)).reshape(-1, x.shape[-1])[:, None]
    t_kernel = minn_rtl_detect_triton(
        planar, quarter_len=Q, hysteresis=h, max_events=E,
        segment_len=1024, interpret=True, **kw,
    )
    t_kernel_0 = type(t_kernel)(*[np.asarray(f)[0] for f in t_kernel])

    assert int(t_cplx.count) >= 3  # the stimulus really produces events
    _assert_tables_equal(t_cplx, t_planar)
    _assert_tables_equal(t_cplx, t_kernel_0)


def test_aa_planar_matches_complex(rng):
    x = _x(rng, L=1024)
    ref = M.aa_metric(jnp.asarray(x), 64)
    fast = aa_metric_planar(to_planar(jnp.asarray(x)), 64)
    np.testing.assert_allclose(np.asarray(fast.P_re), np.asarray(ref.P).real, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(fast.P_im), np.asarray(ref.P).imag, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(fast.R), np.asarray(ref.R), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(fast.M), np.asarray(ref.M), rtol=1e-4, atol=1e-5)
