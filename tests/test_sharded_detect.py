"""Fully-sharded detection (dp x sp + cross-shard event merge) == unsharded.

Runs on the virtual 8-device CPU mesh (conftest).  Gates straddling seq-shard
boundaries must merge into single events with globally-resolved peaks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_sync_tpu.kernels.streaming import minn_rtl_detect_planar, to_planar
from ofdm_sync_tpu.parallel.shard import make_stream_mesh, sharded_minn_rtl_detect
from ofdm_sync_tpu.ops.waveforms import build_minn_rtl_preamble

KW = dict(
    quarter_len=32,
    smooth_shift=3,
    threshold_value=3276,
    threshold_frac_bits=15,
    hysteresis=2,
)


def _cl(iq):
    """(batch, branches, 2, L) -> channel-leading (2*branches, batch, L)."""
    b, br, _, L = iq.shape
    return jnp.asarray(iq.reshape(b, 2 * br, L).transpose(1, 0, 2))


def _streams(rng, batch=4, L=4096, boundary_positions=False):
    Q = KW["quarter_len"]
    iq = np.zeros((batch, 2, 2, L), np.float32)
    for b in range(batch):
        sig = np.zeros(L, complex)
        if boundary_positions:
            # peak region lands exactly on a seq-shard boundary (L/4 blocks
            # on a 4-wide seq axis)
            pos = L // 4 - 3 * Q + (b % 2) * (L // 4)
        else:
            pos = 500 + 700 * b
        pre = build_minn_rtl_preamble(
            "qpsk_freq", rng=np.random.default_rng(b), Q=Q
        )
        sig[pos : pos + 5 * Q] = pre
        rx = np.stack([sig, 0.8 * sig])
        rx = rx + 0.05 * (
            rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape)
        )
        iq[b] = np.asarray(to_planar(jnp.asarray(rx)))
    return iq


@pytest.mark.slow
@pytest.mark.parametrize("boundary", [False, True])
def test_sharded_detect_equals_unsharded(rng, boundary):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_stream_mesh(n_data=2, n_seq=4)
    iq = _streams(rng, boundary_positions=boundary)
    table = sharded_minn_rtl_detect(jnp.asarray(iq), mesh, **KW)
    for b in range(iq.shape[0]):
        _, ref = minn_rtl_detect_planar(jnp.asarray(iq[b]), **KW)
        assert int(table.count[b]) == int(ref.count), b
        k = int(ref.count)
        assert k >= 1
        for f in ("gate_start", "gate_close", "peak_idx", "valid", "closed"):
            np.testing.assert_array_equal(
                np.asarray(getattr(table, f))[b][:k],
                np.asarray(getattr(ref, f))[:k],
                err_msg=f"{f} stream {b}",
            )
        np.testing.assert_allclose(
            np.asarray(table.peak_value)[b][:k],
            np.asarray(ref.peak_value)[:k],
            rtol=1e-3,
            atol=1e-6,
        )


@pytest.mark.slow
def test_sharded_detect_emit_unclosed(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_stream_mesh(n_data=2, n_seq=4)
    iq = np.zeros((2, 2, 2, 2048), np.float32)  # zero stream: unclosed gate
    t_closed = sharded_minn_rtl_detect(
        jnp.asarray(iq), mesh, **KW, emit_unclosed=False
    )
    t_open = sharded_minn_rtl_detect(
        jnp.asarray(iq), mesh, **KW, emit_unclosed=True
    )
    assert int(t_closed.count[0]) == 0
    assert int(t_open.count[0]) == 1 and not bool(t_open.closed[0, 0])


@pytest.mark.parametrize(
    "boundary",
    [pytest.param(False, marks=pytest.mark.slow), True],
)
def test_sharded_fused_detect_equals_unsharded(rng, boundary):
    """The multi-device path: per-shard fused kernel (Pallas interpreter on
    the CPU mesh) primed by its halo + table merge == both the unsharded
    kernel and the XLA reference."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from ofdm_sync_tpu.parallel.shard import sharded_minn_rtl_detect_fused
    from ofdm_sync_tpu.kernels.minn_rtl_triton import minn_rtl_detect_triton

    mesh = make_stream_mesh(n_data=2, n_seq=4)
    iq = _streams(rng, boundary_positions=boundary)
    table = sharded_minn_rtl_detect_fused(_cl(iq), mesh, **KW, interpret=True)
    fused_ref = minn_rtl_detect_triton(_cl(iq), **KW, interpret=True)
    for b in range(iq.shape[0]):
        _, ref = minn_rtl_detect_planar(jnp.asarray(iq[b]), **KW)
        assert int(table.count[b]) == int(ref.count), b
        assert int(table.count[b]) == int(fused_ref.count[b]), b
        k = int(ref.count)
        assert k >= 1
        for f in ("gate_start", "gate_close", "peak_idx", "valid", "closed"):
            np.testing.assert_array_equal(
                np.asarray(getattr(table, f))[b][:k],
                np.asarray(getattr(ref, f))[:k],
                err_msg=f"{f} stream {b} (vs XLA)",
            )
            np.testing.assert_array_equal(
                np.asarray(getattr(table, f))[b][:k],
                np.asarray(getattr(fused_ref, f))[b][:k],
                err_msg=f"{f} stream {b} (vs unsharded fused)",
            )
        np.testing.assert_allclose(
            np.asarray(table.peak_value)[b][:k],
            np.asarray(ref.peak_value)[:k],
            rtol=1e-3,
            atol=1e-6,
        )


@pytest.mark.parametrize("n_data,n_seq", [(1, 8), (8, 1), (4, 2), (1, 2)])
def test_sharded_fused_mesh_shapes(rng, n_data, n_seq):
    """Every (data, seq) split of the 8 devices (and a 2-device mesh)
    gives the single-device table, with gates placed on the seams."""
    from ofdm_sync_tpu.conformance.device_checks import table_diff
    from ofdm_sync_tpu.kernels.minn_rtl_triton import minn_rtl_detect
    from ofdm_sync_tpu.parallel.shard import sharded_minn_rtl_detect_fused

    devs = jax.devices()[: n_data * n_seq]
    mesh = make_stream_mesh(n_data=n_data, n_seq=n_seq, devices=devs)
    L = 8192
    iq = np.concatenate([
        _streams(rng, batch=4, L=L, boundary_positions=True),
        _streams(rng, batch=4, L=L),
    ])
    table = sharded_minn_rtl_detect_fused(_cl(iq), mesh, **KW, interpret=True)
    ref = minn_rtl_detect(_cl(iq), **KW, max_events=8)
    assert table_diff(ref, table, name="sharded", pv_rtol=1e-3) == []


def test_sharded_fused_int16_and_emit_unclosed():
    """ADC-width int16 halos ride the ppermute as int16 and give the
    float32 table; a gate open at the stream end surfaces on request."""
    from ofdm_sync_tpu.parallel.shard import sharded_minn_rtl_detect_fused

    mesh = make_stream_mesh(n_data=1, n_seq=4, devices=jax.devices()[:4])
    r = np.random.default_rng(5)
    L = 4096
    x = np.round(3 * r.standard_normal((4, 2, L))).astype(np.float32)
    t = np.arange(L)
    x[0, 1, L - 200:] += np.round(40 * np.cos(0.2 * t[L - 200:]))
    x[1, 1, L - 200:] += np.round(40 * np.sin(0.2 * t[L - 200:]))
    x[0, 0, L // 2 - 100:L // 2 + 60] += np.round(
        40 * np.cos(0.2 * t[:160])
    )
    a = sharded_minn_rtl_detect_fused(jnp.asarray(x), mesh, **KW,
                                      interpret=True)
    b = sharded_minn_rtl_detect_fused(jnp.asarray(x, jnp.int16), mesh, **KW,
                                      interpret=True)
    for f in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    u = sharded_minn_rtl_detect_fused(jnp.asarray(x), mesh, **KW,
                                      emit_unclosed=True, interpret=True)
    assert int(u.count[1]) == int(a.count[1]) + 1
    assert not bool(u.closed[1, int(u.count[1]) - 1])


def test_sharded_fused_needs_gpu_or_interpret():
    from ofdm_sync_tpu.parallel.shard import sharded_minn_rtl_detect_fused

    mesh = make_stream_mesh(n_data=1, n_seq=2, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="GPU"):
        sharded_minn_rtl_detect_fused(
            jnp.zeros((4, 1, 4096), jnp.float32), mesh, **KW
        )


def test_sharded_fused_rejects_short_shards():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from ofdm_sync_tpu.parallel.shard import sharded_minn_rtl_detect_fused

    mesh = make_stream_mesh(n_data=2, n_seq=4)
    iq = jnp.zeros((4, 2, 256), jnp.float32)  # 64-sample shards < the halo
    with pytest.raises(ValueError, match="halo"):
        sharded_minn_rtl_detect_fused(iq, mesh, **KW, interpret=True)


def test_sharded_zc_detect_from_iq(rng):
    """End-to-end sharded ZC detection (per-shard FFT matched filter +
    normalization + CFAR + merge) == `extract_gate_events` on the unsharded
    normalized magnitudes truncated to L."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from ofdm_sync_tpu.ops.detect import extract_gate_events
    from ofdm_sync_tpu.ops.metrics import zc_normalized_correlation_per_branch
    from ofdm_sync_tpu.ops.waveforms import build_pss_symbol
    from ofdm_sync_tpu.ops.windows import running_sum_stream
    from ofdm_sync_tpu.parallel.shard import sharded_zc_detect
    from ofdm_sync_tpu.params import SYS_30M72

    ref = build_pss_symbol(SYS_30M72)  # 2048 samples
    R = ref.shape[-1]
    W = 1024
    L_sig, batch = 16384, 2
    rx = np.zeros((batch, 2, L_sig), complex)
    for b in range(batch):
        pos = L_sig // 4 - R // 2 + 128 * b  # correlation peak near a shard
        rx[b, :, pos:pos + R] = np.stack([ref, 0.8 * ref])
    rx += 0.01 * (
        rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape)
    )

    kw = dict(corr_window=W, min_corr_mag=0.1, hysteresis=64, max_events=8)
    thr = int(4.0 * (1 << 15) / W)
    mesh = make_stream_mesh(n_data=2, n_seq=4)
    t_s = sharded_zc_detect(jnp.asarray(rx), mesh, reference=ref, **kw)

    for b in range(batch):
        mag = jnp.abs(zc_normalized_correlation_per_branch(
            jnp.asarray(rx[b]), ref
        ))[:L_sig].astype(jnp.float32)
        local = running_sum_stream(mag, W)
        above = ((jnp.arange(L_sig) >= W)
                 & (mag * float(1 << 15) >= local * float(thr))
                 & (mag >= 0.1))
        t_u = extract_gate_events(above, mag, hysteresis=64, max_events=8,
                                  tie="first", emit_unclosed=True)
        k = int(t_u.count)
        assert int(t_s.count[b]) == k and k >= 1, (b, k)
        for f in ("gate_start", "gate_close", "peak_idx", "valid", "closed"):
            np.testing.assert_array_equal(
                np.asarray(getattr(t_s, f))[b][:k],
                np.asarray(getattr(t_u, f))[:k],
                err_msg=f"{f} stream {b}",
            )
        np.testing.assert_allclose(
            np.asarray(t_s.peak_value)[b][:k],
            np.asarray(t_u.peak_value)[:k], rtol=1e-4,
        )


@pytest.mark.slow
def test_sharded_fused_priming_regimes(rng):
    """Review-driven regression: the halo priming must stay exact for
    (a) large smooth_shift (long scan memory), (b) hysteresis wider than
    the old fixed tail, and (c) int16 ADC input (the XLA halo pass must
    not do integer arithmetic)."""
    from ofdm_sync_tpu.parallel.shard import sharded_minn_rtl_detect_fused

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_stream_mesh(n_data=2, n_seq=4)
    Q = 32
    L = 1 << 14
    Lb = L // 4
    iq = np.zeros((2, 2, 2, L), np.float32)
    for b in range(2):
        sig = np.zeros(L, complex)
        pre = build_minn_rtl_preamble(
            "qpsk_freq", rng=np.random.default_rng(b), Q=Q
        )
        # one event straddling a seq boundary, one interior
        for pos in (Lb - 2 * Q + 37 * b, 2 * Lb + 500):
            sig[pos : pos + 5 * Q] = pre
        rx = np.stack([sig, 0.8 * sig]) + 0.03 * (
            rng.standard_normal((2, L)) + 1j * rng.standard_normal((2, L))
        )
        iq[b] = np.asarray(to_planar(jnp.asarray(rx)))

    for kw in (
        dict(quarter_len=Q, smooth_shift=6, threshold_value=3276,
             threshold_frac_bits=15, hysteresis=2),
        dict(quarter_len=Q, smooth_shift=3, threshold_value=3276,
             threshold_frac_bits=15, hysteresis=31),
    ):
        table = sharded_minn_rtl_detect_fused(_cl(iq), mesh, **kw,
                                              interpret=True)
        for b in range(2):
            _, ref = minn_rtl_detect_planar(jnp.asarray(iq[b]), **kw)
            assert int(table.count[b]) == int(ref.count), (kw, b)
            k = int(ref.count)
            assert k >= 1
            for f in ("gate_start", "gate_close", "peak_idx"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(table, f))[b][:k],
                    np.asarray(getattr(ref, f))[:k],
                    err_msg=f"{f} {kw}",
                )

    # int16: channel-leading quantized input == f32 input on the same values
    kw = dict(quarter_len=Q, smooth_shift=3, threshold_value=3276,
              threshold_frac_bits=15, hysteresis=2)
    cl = jnp.asarray(
        np.clip(np.round(iq.reshape(2, 4, L).transpose(1, 0, 2) * 512),
                -2048, 2047)
    )
    t16 = sharded_minn_rtl_detect_fused(
        cl.astype(jnp.int16), mesh, **kw, interpret=True,
    )
    tf = sharded_minn_rtl_detect_fused(
        cl.astype(jnp.float32), mesh, **kw, interpret=True,
    )
    for f in ("count", "gate_start", "gate_close", "peak_idx", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(t16, f)), np.asarray(getattr(tf, f)),
            err_msg=f,
        )
    assert int(np.asarray(t16.count).sum()) >= 2


@pytest.mark.slow
def test_sharded_fused_seam_fuzz(rng):
    """Seeded fuzz of the table-level seam merge: 50 seeds x 2 streams of
    random noise levels and random preamble placements (including directly
    on seams), sharded == unsharded for every stream.  All 100 streams ride
    ONE sharded dispatch (the batch axis) so the fuzz stays cheap."""
    from ofdm_sync_tpu.parallel.shard import sharded_minn_rtl_detect_fused

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_stream_mesh(n_data=2, n_seq=4)
    Q = 32
    L = 1 << 12
    Lb = L // 4
    n_seeds = 50
    iq = np.zeros((2 * n_seeds, 2, 2, L), np.float32)
    for seed in range(n_seeds):
        r = np.random.default_rng(1000 + seed)
        for b in range(2):
            sig = np.zeros(L, complex)
            pre = build_minn_rtl_preamble(
                "qpsk_freq", rng=np.random.default_rng(seed * 2 + b), Q=Q
            )
            n_ev = int(r.integers(1, 4))
            for _ in range(n_ev):
                if r.random() < 0.5:
                    # straddle a random seam
                    k = int(r.integers(1, 4))
                    pos = k * Lb - int(r.integers(1, 5 * Q))
                else:
                    pos = int(r.integers(0, L - 5 * Q))
                pos = max(0, min(L - 5 * Q - 1, pos))
                sig[pos : pos + 5 * Q] = pre
            noise = float(r.uniform(0.02, 0.2))
            rx = np.stack([sig, 0.8 * sig]) + noise * (
                r.standard_normal((2, L)) + 1j * r.standard_normal((2, L))
            )
            iq[2 * seed + b] = np.asarray(to_planar(jnp.asarray(rx)))
    table = sharded_minn_rtl_detect_fused(_cl(iq), mesh, **KW, interpret=True)
    refs = jax.vmap(
        lambda s: minn_rtl_detect_planar(s, **KW)[1]
    )(jnp.asarray(iq))
    for b in range(2 * n_seeds):
        tag = f"seed {b // 2} stream {b % 2}"
        np.testing.assert_array_equal(
            np.asarray(table.count)[b], np.asarray(refs.count)[b],
            err_msg=tag,
        )
        k = int(refs.count[b])
        for f in ("gate_start", "gate_close", "peak_idx", "valid", "closed"):
            np.testing.assert_array_equal(
                np.asarray(getattr(table, f))[b][:k],
                np.asarray(getattr(refs, f))[b][:k],
                err_msg=f"{f} {tag}",
            )


@pytest.mark.slow
def test_sharded_fused_seam_ulp_adversarial():
    """Adversarial near-threshold seam behavior (the float-association
    caveat of the halo-primed seams): bisect a single-sample
    perturbation until the threshold compare at the LAST sample before a
    seq-shard seam sits at its f32 knife edge, then assert the merged table
    is still a LEGAL outcome at and around the boundary — no dropped event,
    no duplicated event, peak preserved.

    Construction: a preamble placed so its metric's rising threshold
    crossing happens AT the last sample before seam 2, then the preamble
    GAIN g is bisected until the XLA-path above-bit at that sample flips.
    At the bisection limit the compare operands (corr_scaled vs
    energy_scaled, both ~5e5) differ by less than one f32 ulp of their
    magnitude (the margin moves ~3e5 per unit g; one ulp of g moves it
    ~0.02, below the operands' 0.03 ulp).  Probes at the boundary and
    +/- 1, 4, 16 g-ulps cover the (possibly different) flip points of the
    kernel ladder and the priming pass."""
    from ofdm_sync_tpu.ops.metrics import minn_rtl_metric
    from ofdm_sync_tpu.parallel.shard import sharded_minn_rtl_detect_fused

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_stream_mesh(n_data=2, n_seq=4)
    Q = KW["quarter_len"]
    L = 1 << 12
    seam = L // 2  # seam between shards 1 and 2
    n_star = seam - 1  # last sample before the seam: inside the final-h halo

    rng0 = np.random.default_rng(7)
    pre = build_minn_rtl_preamble("qpsk_freq", rng=np.random.default_rng(3),
                                  Q=Q)
    noise = 0.05 * (
        rng0.standard_normal((2, L)) + 1j * rng0.standard_normal((2, L))
    )
    metric_kw = dict(
        smooth_shift=KW["smooth_shift"],
        threshold_value=KW["threshold_value"],
        threshold_frac_bits=KW["threshold_frac_bits"],
        quarter_len=Q,
    )

    def build(pos, g=1.0):
        sig = np.zeros(L, complex)
        sig[pos : pos + 5 * Q] = pre
        rx = np.float32(g) * np.stack([sig, 0.8 * sig]) + noise
        return np.asarray(to_planar(jnp.asarray(rx)))  # (2, 2, L)

    def rising_edge(planar, lo_win, hi_win):
        rx_c = (planar[:, 0] + 1j * planar[:, 1]).astype(np.complex64)
        st = minn_rtl_metric(jnp.asarray(rx_c), **metric_kw)
        ab = np.asarray(st.above_threshold)
        idx = np.flatnonzero(ab[lo_win:hi_win])
        assert idx.size, "no threshold crossing in the preamble window"
        return lo_win + int(idx[0])

    # ALIGN the metric's rising threshold crossing JUST BEFORE n_star
    # (above[n_star] True at g=1, with the crossing as close as position
    # granularity allows): start from the empirically-observed ~7Q
    # crossing delay and correct with the measured edge position (noise is
    # frozen; the gain bisection below does the sub-sample part).  The
    # compare ratio is gain-invariant on the noiseless preamble, so gain
    # can only delay the crossing (toward low SNR) -- the knife edge at
    # n_star is reached by bisecting g DOWN from 1.
    pos = seam - 7 * Q
    for _ in range(6):
        edge_n = rising_edge(build(pos), pos, pos + 9 * Q)
        if n_star - 2 <= edge_n <= n_star:
            break
        pos = pos + (n_star - edge_n)
        if edge_n > n_star:
            pos -= 1  # land on the below side of the granularity jump
    assert n_star - 2 <= edge_n <= n_star, (edge_n, n_star)
    base_sig = build(pos, 1.0) - np.asarray(
        to_planar(jnp.asarray(noise))
    )  # planar preamble-only component
    base_noise = np.asarray(to_planar(jnp.asarray(noise)))

    @jax.jit
    def above_at_nstar(g):
        x = jnp.asarray(base_sig) * g + jnp.asarray(base_noise)
        rx_c = (x[:, 0] + 1j * x[:, 1]).astype(jnp.complex64)
        st = minn_rtl_metric(rx_c, **metric_kw)
        return st.above_threshold[n_star]

    # bracket in gain: above at g=1 (edge aligned <= n_star); descending g
    # delays the crossing past n_star at some point
    hi = np.float32(1.0)
    a_hi = bool(above_at_nstar(hi))
    assert a_hi, "crossing not above at g=1 despite alignment"
    lo = None
    for g in (0.5, 0.25, 0.1, 0.05, 0.02, 0.005):
        if not bool(above_at_nstar(np.float32(g))):
            lo, a_lo = np.float32(g), False
            break
    assert lo is not None, "no gain low enough to delay the crossing"
    for _ in range(60):  # past f32 resolution -> knife edge
        mid = np.float32((float(lo) + float(hi)) / 2)
        if mid == lo or mid == hi:
            break
        if bool(above_at_nstar(mid)) == a_lo:
            lo = mid
        else:
            hi = mid
    edge = float(hi)
    ulp = abs(np.spacing(np.float32(edge)))

    shard_fn = jax.jit(
        lambda v: sharded_minn_rtl_detect_fused(
            _cl(v), mesh, **KW, interpret=True,
        ),
    )
    census = []
    for k_ulp in (-16.0, -4.0, -1.0, 0.0, 1.0, 4.0, 16.0):
        g = np.float32(edge + k_ulp * ulp)
        x = (base_sig * g + base_noise).astype(np.float32)
        _, ref = minn_rtl_detect_planar(jnp.asarray(x), **KW)
        tab = shard_fn(np.stack([x, x]))
        rc = int(ref.count)
        sc = int(np.asarray(tab.count)[0])
        r_peaks = set(np.asarray(ref.peak_idx)[:rc].tolist())
        s_peaks_list = np.asarray(tab.peak_idx)[0][:sc].tolist()
        s_peaks = set(s_peaks_list)
        # LEGALITY ENVELOPE:
        # 1. no duplicated events in the merged table
        assert len(s_peaks_list) == len(s_peaks), (k_ulp, s_peaks_list)
        # 2. counts differ by at most one seam merge/split
        assert abs(sc - rc) <= 1, (k_ulp, sc, rc)
        # 3. every event far from the seam is preserved exactly
        for p in r_peaks:
            if abs(p - seam) > 5 * Q:
                assert p in s_peaks, (k_ulp, p, s_peaks)
        # 4. the detection itself never drops: something peaks in the
        #    preamble's metric region on both paths
        region = range(pos, pos + 8 * Q)
        assert any(p in region for p in r_peaks), (k_ulp, r_peaks)
        assert any(p in region for p in s_peaks), (k_ulp, s_peaks)
        census.append((k_ulp, sc == rc and r_peaks == s_peaks))
    exact = sum(1 for _, eq in census if eq)
    # the envelope held for every probe; record how often the tables were
    # bit-identical at the knife edge (diagnostic, not a requirement)
    print(f"seam ulp census: {exact}/{len(census)} exact, edge delta "
          f"gain {edge:.9f} (bisected to 1 f32 ulp)")
    assert exact >= len(census) - 2, census
