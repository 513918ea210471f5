"""The fused Minn-RTL GPU kernel (`kernels.minn_rtl_triton`) in the Pallas
interpreter, against the XLA datapath and the C++ oracle, plus the route
choice, the segment/halo arithmetic and the detector entry points.

Stimuli are integer-valued (small-integer ADC-style IQ), so every window
sum is exact in float32 on both sides and the tables must be equal field
for field: only the smoothing IIR is associated differently, and a
threshold compare that sat within an ulp of it would show up as a real
mismatch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_sync_tpu.conformance.device_checks import table_diff
from ofdm_sync_tpu.kernels import minn_rtl_triton as mt
from ofdm_sync_tpu.models.detectors import MinnRTLDetector
from ofdm_sync_tpu.ops import metrics as M
from ofdm_sync_tpu.ops.detect import extract_gate_events
from ofdm_sync_tpu.params import MinnRTLParams


def _kw(Q, **over):
    kw = dict(quarter_len=Q, smooth_shift=3,
              threshold_value=int(0.10 * (1 << 15)), threshold_frac_bits=15,
              hysteresis=2, max_events=8)
    kw.update(over)
    return kw


def _stimulus(Q, B, L, positions, seed=0, noise=2.0, amp=8.0):
    """(4, B, L) integer-valued f32 with 5Q preambles at (stream, pos)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(Q) + 1j * rng.standard_normal(Q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    x = np.round(noise * rng.standard_normal((4, B, L))).astype(np.float32)
    for b, pos in positions:
        n = min(5 * Q, L - pos)
        for c in range(4):
            plane = pre.real if c % 2 == 0 else pre.imag
            x[c, b, pos:pos + n] += np.round(amp * plane[:n])
    return x


def _xla_table(x, kw, emit_unclosed=False):
    """Plain reference: complex metric + gate extraction, per stream."""
    def one(stream):
        st = M.minn_rtl_metric(
            stream[0::2] + 1j * stream[1::2],
            quarter_len=kw["quarter_len"], smooth_shift=kw["smooth_shift"],
            threshold_value=kw["threshold_value"],
            threshold_frac_bits=kw["threshold_frac_bits"],
        )
        return extract_gate_events(
            st.above_threshold, st.corr_positive,
            hysteresis=kw["hysteresis"], max_events=kw["max_events"],
            valid_from=M.minn_rtl_valid_from(kw["quarter_len"]), tie="last",
            emit_unclosed=emit_unclosed,
        )

    return jax.vmap(one, in_axes=1)(jnp.asarray(x, jnp.float32))


def _assert_equal(ref, out):
    assert table_diff(ref, out, name="kernel") == []


# ---------------------------------------------------------------------------
# kernel == XLA datapath
# ---------------------------------------------------------------------------

SHAPES = [
    # (Q, B, L, segment_len, positions)
    (16, 3, 70 * 16 + 7, None, [(0, 48), (1, 400), (2, 70 * 16 - 90)]),
    (16, 2, 2048, 320, [(0, 300), (1, 630), (1, 1270)]),
    (32, 3, 70 * 32 + 7, 20 * 32, [(0, 96), (1, 11 * 32 + 5), (1, 25 * 32),
                                    (2, 64 * 32)]),
    (32, 2, 4096, 24 * 32, [(0, 24 * 32 - 2 * 32), (1, 48 * 32 - 80)]),
    (32, 1, 3000, 21 * 32, [(0, 21 * 32 - 3 * 32 + 1)]),
    (64, 2, 8192 + 13, None, [(0, 1000), (1, 4000)]),
    (64, 4, 5000, 1024, [(0, 1024 - 100), (2, 2048 - 200), (3, 4500)]),
]


@pytest.mark.parametrize("Q,B,L,seg,positions", SHAPES)
def test_kernel_matches_xla(Q, B, L, seg, positions):
    """Segment seams (halo re-read + table merge) and tail padding."""
    x = _stimulus(Q, B, L, positions)
    kw = _kw(Q)
    out = mt.minn_rtl_detect_triton(jnp.asarray(x), **kw, segment_len=seg,
                                    interpret=True)
    _assert_equal(_xla_table(x, kw), out)
    assert int(np.asarray(out.count).sum()) >= 1


@pytest.mark.parametrize("seg", [None, 320])
def test_kernel_int16_matches_float32(seg):
    """ADC-width ingest: int16 planes give the float32 table bit for bit."""
    x = _stimulus(16, 2, 2048, [(0, 300), (1, 900)])
    kw = _kw(16)
    a = mt.minn_rtl_detect_triton(jnp.asarray(x), **kw, segment_len=seg,
                                  interpret=True)
    b = mt.minn_rtl_detect_triton(jnp.asarray(x, jnp.int16), **kw,
                                  segment_len=seg, interpret=True)
    _assert_equal(a, b)
    _assert_equal(_xla_table(x, kw), b)


@pytest.mark.parametrize("h", [1, 2, 8])
def test_kernel_hysteresis(h):
    x = _stimulus(32, 2, 3000, [(0, 200), (1, 1500)], noise=3.0, amp=6.0)
    kw = _kw(32, hysteresis=h)
    out = mt.minn_rtl_detect_triton(jnp.asarray(x), **kw, segment_len=640,
                                    interpret=True)
    _assert_equal(_xla_table(x, kw), out)


@pytest.mark.parametrize("shift", [0, 1, 6])
def test_kernel_smooth_shift(shift):
    """The IIR's in-block solve (shift 0 has no IIR; 6 has a long memory
    and a wide halo)."""
    Q = 32
    x = _stimulus(Q, 2, 6000, [(0, 500), (1, 3100)])
    kw = _kw(Q, smooth_shift=shift)
    seg = max(mt.halo_len(Q, shift, 2), 640)
    out = mt.minn_rtl_detect_triton(jnp.asarray(x), **kw, segment_len=seg,
                                    interpret=True)
    _assert_equal(_xla_table(x, kw), out)


@pytest.mark.parametrize("E", [1, 3, 5])
def test_kernel_capacity_overflow_across_segments(E):
    """More gates than slots, with gates after the table filled crossing a
    segment seam: a continuation of a dropped gate must stay dropped."""
    Q = 16
    pos = [(0, p) for p in range(60, 1900, 150)]
    x = _stimulus(Q, 1, 2048, pos)
    kw = _kw(Q, max_events=E)
    out = mt.minn_rtl_detect_triton(jnp.asarray(x), **kw, segment_len=320,
                                    interpret=True)
    ref = _xla_table(x, kw)
    assert bool(np.asarray(ref.overflow)[0])
    _assert_equal(ref, out)


def test_kernel_emit_unclosed_tail_gate():
    """A gate still open at the stream end surfaces only when asked."""
    Q = 16
    x = _stimulus(Q, 1, 1200, [(0, 1200 - 4 * Q)])
    kw = _kw(Q)
    for emit in (False, True):
        out = mt.minn_rtl_detect_triton(
            jnp.asarray(x), **kw, emit_unclosed=emit, segment_len=320,
            interpret=True,
        )
        _assert_equal(_xla_table(x, kw, emit_unclosed=emit), out)


def test_kernel_zero_signal():
    x = np.zeros((4, 2, 1024), np.float32)
    out = mt.minn_rtl_detect_triton(jnp.asarray(x), **_kw(16),
                                    interpret=True)
    assert np.asarray(out.count).tolist() == [0, 0]
    assert not np.asarray(out.overflow).any()


def test_kernel_gate_spanning_many_segments():
    """A constant tone keeps one gate open across every segment."""
    Q, L = 16, 2000
    t = np.arange(L)
    x = np.zeros((4, 1, L), np.float32)
    x[0, 0] = np.round(20 * np.cos(0.3 * t))
    x[1, 0] = np.round(20 * np.sin(0.3 * t))
    kw = _kw(Q)
    for emit in (False, True):
        out = mt.minn_rtl_detect_triton(
            jnp.asarray(x), **kw, emit_unclosed=emit, segment_len=320,
            interpret=True,
        )
        _assert_equal(_xla_table(x, kw, emit_unclosed=emit), out)


def test_kernel_zero_lead_is_stream_start():
    """Shard 0 of a sharded run: a zero halo `lead` equals no halo."""
    Q = 16
    x = _stimulus(Q, 2, 2048, [(0, 40), (1, 1300)])
    kw = _kw(Q)
    W = mt.halo_len(Q, 3, 2)
    whole = mt.minn_rtl_detect_triton(jnp.asarray(x), **kw, interpret=True)
    padded = np.concatenate([np.zeros((4, 2, W), np.float32), x], axis=-1)
    led = mt.minn_rtl_detect_triton(jnp.asarray(padded), **kw, lead=W,
                                    interpret=True)
    _assert_equal(whole, led)


@pytest.mark.parametrize("split", [512, 1000, 1024 + 7 * 16])
def test_kernel_split_stream_merges_to_whole(split):
    """Two pieces, the second primed by its `lead` halo and shifted by
    `base`, merged with `merge_stacked_event_tables` (the sharded seam
    rule) give the whole-stream table."""
    from ofdm_sync_tpu.ops.detect import GateEvents, merge_stacked_event_tables

    Q, L = 16, 2048
    x = _stimulus(Q, 2, L, [(0, split - 2 * Q), (1, split - 5 * Q + 3),
                            (1, 200)])
    kw = _kw(Q)
    W = mt.halo_len(Q, 3, 2)
    whole = mt.minn_rtl_detect_triton(jnp.asarray(x), **kw, interpret=True)
    a = mt.minn_rtl_detect_triton(
        jnp.asarray(x[..., :split]), **kw, emit_unclosed=True,
        stream_len=L, interpret=True,
    )
    b = mt.minn_rtl_detect_triton(
        jnp.asarray(x[..., split - W:]), **kw, emit_unclosed=True,
        lead=W, base=split, stream_len=L, interpret=True,
    )
    stk = lambda f: jnp.stack([getattr(a, f), getattr(b, f)])  # noqa: E731
    merged = merge_stacked_event_tables(
        tuple(stk(f) for f in ("gate_start", "gate_close", "peak_idx",
                               "peak_value", "closed", "count",
                               "overflow")),
        h=2, E=8, K=1, tie_last=True, emit_unclosed=False,
    )
    _assert_equal(whole, GateEvents(*merged[:8]))


# ---------------------------------------------------------------------------
# route, shapes and arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "Q,h,shift,ok",
    [(16, 2, 3, True), (512, 2, 3, True), (512, 511, 3, True),
     (8, 2, 3, False), (48, 2, 3, False), (512, 512, 3, False),
     (16, 16, 3, False), (512, 2, 2, False), (128, 2, 1, True),
     (512, 2, 0, True), (1024, 2, 3, False), (1024, 2, 6, True)],
)
def test_supports(Q, h, shift, ok):
    """Power-of-two blocks above h, and IIR weights (1/d)^(Q/2) <= 2^64."""
    assert mt.supports(Q, h, shift) is ok


def test_route_on_cpu_is_xla_unless_interpret():
    assert jax.default_backend() == "cpu"
    assert not mt.use_kernel(512, 3, 2)
    assert mt.use_kernel(512, 3, 2, interpret=True)
    assert not mt.use_kernel(48, 3, 2, interpret=True)  # unsupported Q
    assert not mt.use_kernel(512, 1, 2, interpret=True)  # IIR range


def test_unsupported_shift_takes_the_xla_route():
    """smooth_shift 2 at Q=512 would overflow the in-block IIR weights:
    the dispatcher falls back to the XLA datapath even when asked for the
    kernel, and the kernel itself refuses."""
    x = _stimulus(512, 1, 8192, [(0, 3000)])
    kw = _kw(512, smooth_shift=2)
    out = mt.minn_rtl_detect(jnp.asarray(x), **kw, interpret=True)
    _assert_equal(_xla_table(x, kw), out)
    with pytest.raises(ValueError, match="IIR"):
        mt.minn_rtl_detect_triton(jnp.asarray(x), **kw, interpret=True)


def test_dispatch_equal_on_both_routes():
    x = _stimulus(16, 2, 1500, [(0, 200), (1, 800)])
    kw = _kw(16)
    a = mt.minn_rtl_detect(jnp.asarray(x), **kw)
    b = mt.minn_rtl_detect(jnp.asarray(x), **kw, interpret=True)
    _assert_equal(a, b)


@pytest.mark.parametrize(
    "shift,mem", [(0, 0), (1, 63), (3, 255), (6, 2047)]
)
def test_scan_memory(shift, mem):
    assert mt.scan_memory(shift) == mem


@pytest.mark.parametrize(
    "Q,shift,h,nh", [(16, 3, 2, 20), (32, 3, 2, 12), (512, 3, 2, 4),
                     (512, 6, 2, 8), (64, 3, 8, 8)]
)
def test_halo_blocks(Q, shift, h, nh):
    """3 blocks rebuild the window sums, the rest cover the IIR memory and
    the h-sample gate tail."""
    assert mt.halo_blocks(Q, shift, h) == nh
    assert mt.halo_len(Q, shift, h) == nh * Q
    assert (nh - 3) * Q >= mt.scan_memory(shift) + 1 + h


@pytest.mark.parametrize(
    "batch,L,Q,expect",
    [(512, 1 << 18, 512, 1 << 18), (64, 1 << 18, 512, 32768),
     (1, 1 << 18, 512, 16384), (4, 4096, 16, 4096), (2048, 1 << 16, 512, 65536)],
)
def test_segment_len_for(batch, L, Q, expect):
    """Enough programs to fill the card, while the halo stays under 1/8 of
    a segment."""
    nh = mt.halo_blocks(Q, 3, 2)
    seg = mt.segment_len_for(batch, L, Q, nh)
    assert seg == expect
    assert seg % Q == 0
    n_seg = -(-L // seg)
    assert seg >= min(8 * nh * Q, -(-L // Q) * Q) or n_seg == 1


@pytest.mark.parametrize(
    "kwargs,msg",
    [(dict(quarter_len=48), "power of two"),
     (dict(hysteresis=16), "power of two"),
     (dict(lead=7), "lead must be"),
     (dict(segment_len=100), "segment_len")],
)
def test_kernel_rejects_bad_arguments(kwargs, msg):
    x = jnp.zeros((4, 1, 1024), jnp.float32)
    kw = _kw(16)
    kw.update(kwargs)
    with pytest.raises(ValueError, match=msg):
        mt.minn_rtl_detect_triton(x, **kw, interpret=True)


# ---------------------------------------------------------------------------
# detector entry points and the C++ oracle
# ---------------------------------------------------------------------------

def test_detector_detect_batch_matches_detect():
    """`MinnRTLDetector.detect_batch` (channel-leading batch) == `detect`
    (one complex stream at a time)."""
    Q = 32
    det = MinnRTLDetector(params=MinnRTLParams(quarter_len=Q))
    x = _stimulus(Q, 3, 3000, [(0, 300), (1, 1200), (2, 2500)])
    table = det.detect_batch(jnp.asarray(x))
    for b in range(3):
        rx = x[0::2, b] + 1j * x[1::2, b]
        _, res = det.detect(rx)
        pk = np.asarray(table.peak_idx)[b, : int(table.count[b])]
        assert [e.peak_index for e in res.events] == pk.tolist()


def test_detector_detect_frames_kernel_route():
    """The receive chain's front half gives the same windows on both
    routes."""
    Q = 32
    det = MinnRTLDetector(params=MinnRTLParams(quarter_len=Q))
    x = _stimulus(Q, 1, 4000, [(0, 500), (0, 2500)])
    rx = x[0::2, 0] + 1j * x[1::2, 0]
    a = det.detect_frames(rx, frame_len=256)
    b = det.detect_frames(rx, frame_len=256, interpret=True)
    for u, v in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(u, v)
    assert [e.peak_index for e in a[0].events] == [
        e.peak_index for e in b[0].events
    ]
    assert a[3].sum() == 2


def test_native_oracle_agrees_with_kernel():
    """The C++ fixed-point oracle (integer arithmetic-shift smoothing) and
    the float kernel: equal counts, peaks and peak values; gate edges within
    the reference's +-16-sample RTL tolerance
    (ref/test_minn_preamble_detector.py:446-451)."""
    from ofdm_sync_tpu.native import minn_rtl_detect_native

    Q = 64
    x = _stimulus(Q, 2, 6000, [(0, 900), (1, 2000), (1, 4400)],
                  noise=1.0, amp=4.0)
    kw = _kw(Q)
    out = mt.minn_rtl_detect_triton(jnp.asarray(x), **kw, interpret=True)
    for b in range(2):
        nat = minn_rtl_detect_native(
            x[:, b].reshape(2, 2, -1).astype(np.int16), quarter_len=Q,
            smooth_shift=3, threshold_value=kw["threshold_value"],
            threshold_frac_bits=15, hysteresis=2,
        )
        c = int(out.count[b])
        assert nat.count == c >= 1
        np.testing.assert_array_equal(nat.peak_idx,
                                      np.asarray(out.peak_idx)[b, :c])
        np.testing.assert_array_equal(nat.peak_value,
                                      np.asarray(out.peak_value)[b, :c])
        for f in ("gate_start", "gate_close"):
            d = np.abs(getattr(nat, f) - np.asarray(getattr(out, f))[b, :c])
            assert d.max() <= 16
