"""Sharded device-side frame re-emission == unsharded `ops.extract`.

Windows placed ON seq-shard seams must assemble exactly from per-shard
contributions (each shard contributes only the samples it holds; one psum
over 'seq' -- no stream all_gather).  Covers the channel-leading layout,
int16 input, and the end-to-end sharded receive chain.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ofdm_sync_tpu.ops.detect import GateEvents
from ofdm_sync_tpu.ops.extract import extract_frames_batched
from ofdm_sync_tpu.parallel.shard import (
    make_stream_mesh,
    sharded_extract_frames,
)

C = 4
L = 4096
E = 8


def _table(batch, events):
    """events: list per stream of peak indices."""
    valid = np.zeros((batch, E), bool)
    peak = np.zeros((batch, E), np.int32)
    count = np.zeros((batch,), np.int32)
    for b, peaks in enumerate(events):
        for k, p in enumerate(peaks):
            valid[b, k] = True
            peak[b, k] = p
        count[b] = len(peaks)
    z = np.zeros((batch, E), np.int32)
    return GateEvents(
        valid=jnp.asarray(valid), closed=jnp.asarray(valid),
        gate_start=jnp.asarray(peak), gate_close=jnp.asarray(peak),
        peak_idx=jnp.asarray(peak),
        peak_value=jnp.zeros((batch, E), jnp.float32),
        count=jnp.asarray(count), overflow=jnp.asarray(z[:, 0], bool),
    )


@pytest.mark.parametrize("n_data,n_seq", [(1, 8), (2, 4)])
def test_sharded_extract_matches_unsharded(rng, n_data, n_seq):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_stream_mesh(n_data, n_seq)
    batch = 4
    F = 700
    blk = L // n_seq
    x = rng.standard_normal((C, batch, L)).astype(np.float32)
    # windows straddling seams, at stream edges, and mid-shard
    events = [
        [blk - 10, 2 * blk - F + 3],     # spans seam 1; ends crossing seam 2
        [0, L - 1],                       # clipped at both stream edges
        [3 * blk - F // 2],               # centered on seam 3
        [],                               # no events
    ]
    tb = _table(batch, events)
    frames_s, starts_s, valid_s = jax.jit(
        lambda v, t: sharded_extract_frames(
            v, t, mesh, frame_len=F, timing_offset=-13, max_frames=4
        )
    )(jnp.asarray(x), tb)
    frames_u, starts_u, valid_u = extract_frames_batched(
        jnp.asarray(x.transpose(1, 0, 2)), tb,
        frame_len=F, timing_offset=-13, max_frames=4,
    )
    np.testing.assert_array_equal(np.asarray(valid_s), np.asarray(valid_u))
    np.testing.assert_array_equal(np.asarray(starts_s), np.asarray(starts_u))
    np.testing.assert_array_equal(np.asarray(frames_s), np.asarray(frames_u))


@pytest.mark.parametrize("n_seq", [2, 4])
def test_sharded_extract_int16_matches_unsharded(rng, n_seq):
    """ADC-width int16 streams: windows on the seams, batch over one
    device group, equal to the unsharded extraction."""
    mesh = make_stream_mesh(1, n_seq, devices=jax.devices()[:n_seq])
    batch = 2
    blk = L // n_seq
    F = 600
    x = np.round(100 * rng.standard_normal((C, batch, L))).astype(np.int16)
    tb = _table(batch, [[blk - 5, L - 1], [0, blk + 3]])
    frames_s, starts_s, valid_s = sharded_extract_frames(
        jnp.asarray(x), tb, mesh, frame_len=F, timing_offset=-7,
        max_frames=4,
    )
    frames_u, starts_u, valid_u = extract_frames_batched(
        jnp.asarray(x.transpose(1, 0, 2)), tb,
        frame_len=F, timing_offset=-7, max_frames=4,
    )
    np.testing.assert_array_equal(np.asarray(valid_s), np.asarray(valid_u))
    np.testing.assert_array_equal(np.asarray(starts_s), np.asarray(starts_u))
    np.testing.assert_array_equal(np.asarray(frames_s), np.asarray(frames_u))


def test_sharded_receive_chain_two_frames(rng):
    """The multi-device receive chain (`parallel.shard.
    sharded_minn_rtl_receive`): a real two-frame Minn-RTL stimulus
    (reference minn_rtl.py:884-889 geometry) with the SECOND frame's window
    spanning a seq-shard seam -> sharded fused detect + sharded device-side
    frame re-emission == the unsharded `MinnRTLDetector.detect_frames`
    chain bit-for-bit, both frames recovered, and the demodulated data
    symbol at the noise floor."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from ofdm_sync_tpu.models.detectors import MinnRTLDetector
    from ofdm_sync_tpu.ops.estimate import (
        equalize, evm_rms_db, align_complex_gain, ls_channel_estimate,
    )
    from ofdm_sync_tpu.ops.waveforms import (
        build_minn_rtl_preamble, ofdm_fft_used,
    )
    from ofdm_sync_tpu.params import MinnRTLParams, SystemParams
    from ofdm_sync_tpu.parallel.shard import sharded_minn_rtl_receive
    from ofdm_sync_tpu.pipelines import common

    Q = 16
    n_seq = 4
    Ltm = 4096                        # seq shard = 1024
    sys_p = SystemParams(
        n_fft=64, num_active=48, cp_len=16, sample_rate_hz=1e6,
        # second frame starts at pre_pad + 2*frame_len = 924 and spans the
        # shard-0|1 seam at 1024 (frame_len = 5Q + 2*(cp+nfft) = 240)
        tx_pre_pad=444,
    )
    # 0.3 threshold: at Q=16 the smoothed ratio metric is noisier than at
    # the reference's Q=512 (where 0.10 is tuned).  The scale-free ratio
    # can still gate on noise-only regions (a property the reference's
    # metric shares), so the assertions below LOCATE the two true frames
    # among the events rather than demanding exactly two.
    params = MinnRTLParams(
        quarter_len=Q, threshold_value=int(0.3 * (1 << 15))
    )
    frame_len = 5 * Q + 2 * (sys_p.cp_len + sys_p.n_fft)
    assert sys_p.tx_pre_pad + 2 * frame_len < Ltm // n_seq < \
        sys_p.tx_pre_pad + 2 * frame_len + frame_len

    preamble = build_minn_rtl_preamble(params.seq_type, rng, Q=Q, sys=sys_p)
    setup = common.build_setup(
        preamble, rng, sys=sys_p, channel_name=None, cir_mode="two",
        snr_db=30.0, cfo_hz=0.0, two_frames=True,
    )
    rx = np.zeros((1, Ltm), complex)
    rx[:, : setup.rx.shape[-1]] = setup.rx[:1]

    # unsharded flagship chain
    det = MinnRTLDetector(sys_p, params)
    result, frames_u, starts_u, valid_u = det.detect_frames(
        rx, frame_len=frame_len, max_frames=4, interpret=True,
    )
    # both true frames must be among the detected windows (start = s0 - 1:
    # the RTL peak sits at s0 + 6Q - 1)
    true_starts = [sys_p.tx_pre_pad, sys_p.tx_pre_pad + 2 * frame_len]
    true_k = []
    for ts in true_starts:
        hits = [
            k for k in range(len(valid_u))
            if valid_u[k] and abs(int(starts_u[k]) - ts) <= 4
        ]
        assert hits, (ts, starts_u, valid_u)
        true_k.append(hits[0])

    # sharded chain (mesh (1, n_seq))
    mesh = make_stream_mesh(1, n_seq, devices=jax.devices()[:n_seq])
    planar = jnp.asarray(
        np.stack([rx[0].real, rx[0].imag]).astype(np.float32)
    )[:, None, :]
    table, frames_s, starts_s, valid_s = sharded_minn_rtl_receive(
        planar, mesh,
        quarter_len=Q, smooth_shift=params.smooth_shift,
        threshold_value=params.threshold_value,
        threshold_frac_bits=params.threshold_frac_bits,
        hysteresis=params.hysteresis,
        timing_offset=params.timing_offset - 6 * Q,
        frame_len=frame_len, max_frames=4, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(valid_s)[0], valid_u)
    np.testing.assert_array_equal(np.asarray(starts_s)[0], starts_u)
    np.testing.assert_array_equal(np.asarray(frames_s)[0], frames_u)

    # both true frames demodulate at the noise floor (30 dB SNR -> EVM ~3%;
    # the 1-sample early window start stays inside the CP and is absorbed
    # by the LS equalizer)
    n_fft, cp = sys_p.n_fft, sys_p.cp_len
    data_n_off = 5 * Q + cp + n_fft + cp
    pilot_n_off = 5 * Q + cp
    for k in true_k:
        fp = np.asarray(frames_s)[0, k]
        ant = fp[0] + 1j * fp[1]
        pilot_bins = np.asarray(ofdm_fft_used(
            jnp.asarray(ant[pilot_n_off:pilot_n_off + n_fft]), sys_p))
        data_bins = np.asarray(ofdm_fft_used(
            jnp.asarray(ant[data_n_off:data_n_off + n_fft]), sys_p))
        h = np.asarray(ls_channel_estimate(
            jnp.asarray(pilot_bins), jnp.asarray(setup.pilot_used)))
        eq = np.asarray(equalize(jnp.asarray(data_bins), jnp.asarray(h)))
        eq_al, _ = align_complex_gain(
            jnp.asarray(eq), jnp.asarray(setup.data_used))
        evm, evm_db = evm_rms_db(eq_al, jnp.asarray(setup.data_used))
        assert float(evm) < 0.10, (k, float(evm), float(evm_db))
