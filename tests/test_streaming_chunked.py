"""Chunked streaming API == one-shot detection, for arbitrary chunk splits.

This is the framework's checkpoint/resume + unbounded-stream story: the
carried state is a pytree; splitting the stream at any points must not change
the detected events (reference precedent: the RTL consumes one sample at a
time, ref/minn_preamble_detector.sv)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ofdm_sync_tpu.kernels.streaming import minn_rtl_detect_planar, to_planar
from ofdm_sync_tpu.kernels.streaming_chunked import (
    MinnRTLStreamParams,
    minn_rtl_stream_finalize,
    minn_rtl_stream_init,
    minn_rtl_stream_step,
)
from ofdm_sync_tpu.ops.waveforms import build_minn_rtl_preamble

PARAMS = MinnRTLStreamParams(
    quarter_len=32,
    smooth_shift=3,
    threshold_value=3276,
    threshold_frac_bits=15,
    hysteresis=2,
)


def _make_stream(rng, L=6000, n_pre=2):
    Q = PARAMS.quarter_len
    sig = np.zeros(L, complex)
    for k in range(n_pre):
        pre = build_minn_rtl_preamble(
            "qpsk_freq", rng=np.random.default_rng(k), Q=Q
        )
        pos = 700 + k * 2500
        sig[pos : pos + 5 * Q] = pre
    rx = np.stack([sig, 0.8 * sig])
    rx = rx + 0.05 * (
        rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape)
    )
    return np.asarray(to_planar(jnp.asarray(rx)))


def _run_chunked(iq, splits):
    state = minn_rtl_stream_init(PARAMS, branches=iq.shape[0])
    start = 0
    for end in list(splits) + [iq.shape[-1]]:
        if end > start:
            state = minn_rtl_stream_step(
                state, jnp.asarray(iq[..., start:end]), params=PARAMS
            )
            start = end
    return minn_rtl_stream_finalize(state, params=PARAMS)


@pytest.mark.parametrize(
    "seed",
    [0,
     pytest.param(1, marks=pytest.mark.slow),
     pytest.param(2, marks=pytest.mark.slow)],
)
def test_chunked_equals_oneshot_random_splits(seed):
    rng = np.random.default_rng(seed)
    iq = _make_stream(rng)
    L = iq.shape[-1]
    if seed == 0:
        # quick tier: random split ORDER but chunk sizes from a 3-value set
        # (each distinct chunk length compiles its own stream-step graph;
        # the gate is compile-bound).  The slow seeds keep fully random
        # sizes.
        sizes = rng.choice([256, 384, 512], size=16)
        splits = 200 + np.cumsum(sizes)
        splits = splits[splits < L - 200][:5]
    else:
        splits = np.sort(
            rng.choice(np.arange(200, L - 200), size=5, replace=False)
        )

    _, ref = minn_rtl_detect_planar(
        jnp.asarray(iq),
        quarter_len=PARAMS.quarter_len,
        smooth_shift=PARAMS.smooth_shift,
        threshold_value=PARAMS.threshold_value,
        threshold_frac_bits=PARAMS.threshold_frac_bits,
        hysteresis=PARAMS.hysteresis,
    )
    out = _run_chunked(iq, splits)
    assert int(out.count) == int(ref.count) >= 2
    k = int(ref.count)
    for f in ("gate_start", "gate_close", "peak_idx", "valid", "closed"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out, f))[:k],
            np.asarray(getattr(ref, f))[:k],
            err_msg=f,
        )
    # chunked vs blocked cumsum differ by float reassociation only
    np.testing.assert_allclose(
        np.asarray(out.peak_value)[:k],
        np.asarray(ref.peak_value)[:k],
        rtol=1e-3,
        atol=1e-6,
    )


def test_chunked_tiny_chunks_cross_gate():
    """Chunks smaller than the hysteresis window, cutting straight through a
    gate, still merge into one event."""
    rng = np.random.default_rng(3)
    iq = _make_stream(rng, L=3000, n_pre=1)
    _, ref = minn_rtl_detect_planar(
        jnp.asarray(iq),
        quarter_len=PARAMS.quarter_len,
        smooth_shift=PARAMS.smooth_shift,
        threshold_value=PARAMS.threshold_value,
        threshold_frac_bits=PARAMS.threshold_frac_bits,
        hysteresis=PARAMS.hysteresis,
    )
    splits = list(range(100, 3000, 100))  # 30 x 100-sample chunks
    out = _run_chunked(iq, splits)
    assert int(out.count) == int(ref.count) >= 1
    np.testing.assert_array_equal(
        np.asarray(out.peak_idx), np.asarray(ref.peak_idx)
    )


def test_state_checkpoint_roundtrip(tmp_path):
    """The stream state is a serializable pytree: checkpoint mid-stream,
    restore, continue -- identical events (the checkpoint/resume story)."""
    import jax

    rng = np.random.default_rng(5)
    iq = _make_stream(rng, L=4000, n_pre=2)
    state = minn_rtl_stream_init(PARAMS, branches=2)
    state = minn_rtl_stream_step(state, jnp.asarray(iq[..., :2100]), params=PARAMS)

    leaves, treedef = jax.tree.flatten(state)
    np.savez(tmp_path / "ckpt.npz", *[np.asarray(x) for x in leaves])
    with np.load(tmp_path / "ckpt.npz") as z:
        restored_leaves = [jnp.asarray(z[k]) for k in z.files]
    restored = jax.tree.unflatten(treedef, restored_leaves)

    a = minn_rtl_stream_step(state, jnp.asarray(iq[..., 2100:]), params=PARAMS)
    b = minn_rtl_stream_step(restored, jnp.asarray(iq[..., 2100:]), params=PARAMS)
    ta = minn_rtl_stream_finalize(a, params=PARAMS)
    tb = minn_rtl_stream_finalize(b, params=PARAMS)
    for f in ("count", "gate_start", "peak_idx", "peak_value"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ta, f)), np.asarray(getattr(tb, f)), err_msg=f
        )
    assert int(ta.count) >= 1


def test_finalize_midstream_is_nondestructive():
    rng = np.random.default_rng(4)
    iq = _make_stream(rng, L=3000, n_pre=1)
    state = minn_rtl_stream_init(PARAMS, branches=2)
    state = minn_rtl_stream_step(state, jnp.asarray(iq[..., :1500]), params=PARAMS)
    mid = minn_rtl_stream_finalize(state, params=PARAMS)
    state = minn_rtl_stream_step(state, jnp.asarray(iq[..., 1500:]), params=PARAMS)
    end = minn_rtl_stream_finalize(state, params=PARAMS)
    assert int(end.count) >= int(mid.count)


def test_stream_rebase_fresh_epoch(rng):
    """Rebase clears the event table and restarts the index epoch while
    keeping the physical stream state -- the int32-horizon story for
    unbounded live streams."""
    from ofdm_sync_tpu.kernels.streaming_chunked import minn_rtl_stream_rebase

    Q = PARAMS.quarter_len
    iq1 = _make_stream(np.random.default_rng(0), L=4000, n_pre=1)
    state = minn_rtl_stream_init(PARAMS, branches=2)
    state = minn_rtl_stream_step(state, jnp.asarray(iq1), params=PARAMS)
    t1 = minn_rtl_stream_finalize(state, params=PARAMS)
    assert int(t1.count) >= 1

    state = minn_rtl_stream_rebase(state, params=PARAMS)
    t_empty = minn_rtl_stream_finalize(state, params=PARAMS)
    assert int(t_empty.count) == 0

    # second epoch: new preamble at a known offset from the rebase point
    pos = 900
    sig = np.zeros(4000, complex)
    pre = build_minn_rtl_preamble("qpsk_freq", rng=np.random.default_rng(7), Q=Q)
    sig[pos:pos + 5 * Q] = pre
    rx = np.stack([sig, 0.8 * sig])
    rx = rx + 0.05 * (
        rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape)
    )
    iq2 = np.asarray(to_planar(jnp.asarray(rx)))
    state = minn_rtl_stream_step(state, jnp.asarray(iq2), params=PARAMS)
    t2 = minn_rtl_stream_finalize(state, params=PARAMS)
    assert int(t2.count) >= 1
    best = int(np.argmax(np.where(np.asarray(t2.valid),
                                  np.asarray(t2.peak_value), -np.inf)))
    # gi maps to rebase_point + gi - (3Q - 1): peak ~1Q after preamble end
    peak_rel = int(t2.peak_idx[best]) - (3 * Q - 1)
    expected_peak = pos + 6 * Q - 1  # preamble 5Q + 1Q, inclusive index
    assert abs(peak_rel - expected_peak) <= 8


def test_metric_on_stream_shorter_than_lag():
    """Streams shorter than the correlator lag produce the zero-primed RTL
    output instead of crashing (shift_right delay >= length)."""
    from ofdm_sync_tpu.kernels.streaming import minn_rtl_metric_planar

    iq = jnp.zeros((2, 2, 100), jnp.float32)  # 100 < 3Q = 96? use Q big
    st = minn_rtl_metric_planar(
        iq, quarter_len=512, smooth_shift=3,
        threshold_value=3276, threshold_frac_bits=15,
    )
    assert not bool(np.asarray(st.above_threshold).any())

_DETECT_KW = {k: v for k, v in PARAMS._asdict().items() if k != "tie"}


@pytest.mark.parametrize("chunk", [31, 96, 1000, 4096])
def test_chunked_fixed_chunk_sizes(rng, chunk):
    """A live receiver's fixed block size, shorter and longer than the 3Q
    delay line, == one-shot detection of the whole stream."""
    iq = _make_stream(rng)
    splits = range(chunk, iq.shape[-1], chunk)
    table = _run_chunked(iq, splits)
    _, ref = minn_rtl_detect_planar(jnp.asarray(iq), **_DETECT_KW)
    assert int(ref.count) >= 2
    for f in ("valid", "closed", "gate_start", "gate_close", "peak_idx",
              "count"):
        np.testing.assert_array_equal(
            np.asarray(getattr(table, f)), np.asarray(getattr(ref, f)),
            err_msg=f,
        )
    # the chunked and one-shot window sums differ by float reassociation
    np.testing.assert_allclose(np.asarray(table.peak_value),
                               np.asarray(ref.peak_value), rtol=1e-3,
                               atol=1e-6)


def test_chunked_batch_of_streams_vmapped():
    """The step vmapped over a batch of streams (the live-receiver shape
    the smoke run times) == the batched one-shot detection."""
    import jax

    from ofdm_sync_tpu.conformance.device_checks import minn_stimulus, table_diff
    from ofdm_sync_tpu.kernels.minn_rtl_triton import minn_rtl_detect

    B, n_chunks, chunk = 4, 8, 512
    x = minn_stimulus(B, n_chunks * chunk, PARAMS.quarter_len, every=1)
    streams = jnp.moveaxis(x, 1, 0).reshape(B, 2, 2, -1)
    step = jax.jit(jax.vmap(
        lambda s, c: minn_rtl_stream_step(s, c, params=PARAMS)
    ))
    state = jax.vmap(lambda _: minn_rtl_stream_init(PARAMS, 2))(
        jnp.arange(B)
    )
    for k in range(n_chunks):
        state = step(state, streams[..., k * chunk:(k + 1) * chunk])
    table = jax.vmap(
        lambda s: minn_rtl_stream_finalize(s, params=PARAMS)
    )(state)
    ref = minn_rtl_detect(x, **_DETECT_KW)
    assert table_diff(ref, table, name="stream") == []
    assert int(np.asarray(ref.count).sum()) >= B


def test_epoch_headroom_guard():
    import warnings

    from ofdm_sync_tpu.kernels.streaming_chunked import (
        EPOCH_HORIZON, epoch_headroom,
    )

    state = minn_rtl_stream_init(PARAMS, branches=2)
    assert epoch_headroom(state) == EPOCH_HORIZON
    near = state._replace(base=jnp.int32(EPOCH_HORIZON - 1000))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert epoch_headroom(near) == 1000
    assert any(issubclass(x.category, RuntimeWarning) for x in w)
    with pytest.raises(OverflowError):
        epoch_headroom(state._replace(base=jnp.int32(EPOCH_HORIZON)))
