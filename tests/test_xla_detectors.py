"""The XLA detection paths that replaced the [A][A] and ZC kernels, against
the sequential golden oracles (`conformance.golden`), plus the batched ZC
path and the [A][A] frame re-emission."""

import numpy as np
import jax.numpy as jnp
import pytest

from ofdm_sync_tpu.conformance.golden import (
    golden_aa,
    golden_gate_events,
    golden_zc_streaming,
)
from ofdm_sync_tpu.models.base import events_from_table
from ofdm_sync_tpu.models.detectors import AADetector, ZCStreamingDetector
from ofdm_sync_tpu.ops.waveforms import build_aa_preamble
from ofdm_sync_tpu.params import (
    AADetectorParams,
    SYS_AA_10M,
    ZCStreamingParams,
)


def _aa_stream(rng, L=6000, positions=(1500,), snr_db=10.0, branches=2):
    pre, _, _ = build_aa_preamble(1024, SYS_AA_10M)
    sig = np.zeros(L, complex)
    for p in positions:
        sig[p:p + pre.size] += pre
    rx = np.stack([sig] * branches)
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    return rx + sigma * (rng.standard_normal(rx.shape)
                         + 1j * rng.standard_normal(rx.shape))


@pytest.mark.parametrize("positions", [(1500,), (700, 3800), (4900,)])
def test_aa_detect_matches_golden(rng, positions):
    """[A][A] metric + gate FSM (reference sync_aa.py:421-571) == the
    float64 golden model: same events, peaks within one sample (f32 vs
    f64 |P|^2 can swap two near-equal neighbours)."""
    det = AADetector()
    rx = _aa_stream(rng, positions=positions)
    _, res = det.detect(rx)
    P, R, Mg, valid = golden_aa(rx, det.L)
    above = valid & (Mg >= det.params.threshold)
    gold = golden_gate_events(above, np.abs(P) ** 2,
                              hysteresis=det.params.hysteresis, tie="first",
                              emit_unclosed=True)
    assert len(res.events) == len(gold) == len(positions)
    for e, (start, close, pk, _, closed) in zip(res.events, gold):
        assert abs(e.peak_index - pk) <= 1
        assert abs(e.gate_start - start) <= 2
        assert e.closed == closed


@pytest.mark.parametrize("hyst", [64, 128])
def test_aa_detect_frames_windows(rng, hyst):
    """Frames re-emitted on the device are the planar stream's windows at
    peak - 2L + 1 (reference sync_aa.py:540)."""
    det = AADetector(params=AADetectorParams(hysteresis=hyst))
    rx = _aa_stream(rng, positions=(700, 3800), snr_db=15.0)
    res, frames, starts, valid = det.detect_frames(rx, frame_len=400)
    assert valid.sum() == 2 == len(res.events)
    planar = np.stack([rx.real, rx.imag], axis=1).reshape(4, -1)
    for k, e in enumerate(res.events):
        s = e.peak_index - 2 * det.L + 1
        assert starts[k] == s
        np.testing.assert_allclose(frames[k], planar[:, s:s + 400],
                                   rtol=1e-6, atol=1e-6)


def _zc_stream(rng, det, L=20000, positions=(6000,), noise=0.3):
    ref = det.reference_waveform()
    rx = noise * (rng.standard_normal((2, L))
                  + 1j * rng.standard_normal((2, L)))
    for p in positions:
        rx[:, p:p + ref.size] += np.stack([ref, 0.8 * ref]) / np.sqrt(
            np.mean(np.abs(ref) ** 2))
    return rx


@pytest.mark.parametrize("positions", [(6000,), (3000, 12000)])
def test_zc_detect_cfar_matches_golden(rng, positions):
    """The CFAR + gate FSM on the detector's own |corr| == the sequential
    golden CFAR (reference zc_v2.py:288-336) and FSM (zc_v2.py:360-450)."""
    det = ZCStreamingDetector()
    res = det.detect(_zc_stream(rng, det, positions=positions))
    mag = np.asarray(res.state["corr_mag"], np.float64)
    p = det.params
    _, _, above = golden_zc_streaming(mag, p.corr_window, p.threshold_value,
                                      p.threshold_frac_bits, p.min_corr_mag)
    gold = golden_gate_events(above, mag, hysteresis=p.hysteresis,
                              tie="first", emit_unclosed=True)
    assert len(res.events) == len(gold) >= len(positions)
    for e, (start, close, pk, pv, closed) in zip(res.events, gold):
        assert (e.gate_start, e.peak_index, e.closed) == (start, pk, closed)
        assert e.peak_value == pytest.approx(pv, rel=1e-6)


@pytest.mark.parametrize(
    "normalize,L", [(True, 20000), (True, 40000), (False, 20000)]
)
def test_zc_detect_batch_matches_detect(rng, normalize, L):
    """The batched from-IQ path (overlap-save matched filter over a
    channel-leading batch) == `detect` per stream: same events, peak
    values to the FFT rounding."""
    det = ZCStreamingDetector(
        normalize=normalize,
        params=ZCStreamingParams(min_corr_mag=0.3 if normalize else 30.0),
    )
    streams = [_zc_stream(rng, det, L=L, positions=pos)
               for pos in ((6000,), (2500, L - 6000), ())]
    iq = np.stack([np.stack([s.real, s.imag], axis=1).reshape(4, -1)
                   for s in streams], axis=1).astype(np.float32)
    table = det.detect_batch(jnp.asarray(iq))
    n = iq.shape[-1] + det.reference_waveform().size - 1
    for b, s in enumerate(streams):
        res = det.detect(s.astype(np.complex64))
        got = events_from_table(
            type(table)(*[np.asarray(f)[b] for f in table]), n,
            gate_end_mode="close",
        )
        assert [e.peak_index for e in res.events] == [
            g["peak_index"] for g in got
        ]
        for e, g in zip(res.events, got):
            assert g["peak_value"] == pytest.approx(e.peak_value, rel=1e-4)
    assert int(np.asarray(table.count)[:2].min()) >= 1
