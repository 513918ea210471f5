"""Sliding-window primitives: the vectorized replacement for the reference's
per-sample Python loops and RTL delay-line/running-sum pipelines.

Design: every sliding correlation/energy in the reference decomposes into
  * an elementwise lag product  u[k] = x[k] * conj(x[k +/- lag])
  * a windowed sum              S[d] = sum_{k=d}^{d+W-1} u[k]
  * static shifts of S.

Windowed sums are cumulative-sum differences -- O(L) work, log-depth in parallel,
fully vectorizable over branches/streams.  This replaces:
  * the recursive P/R update of Schmidl-Cox (reference sc.py:57-74),
  * the brute-force O(N) per-offset loops (reference minn.py:92-104,
    park.py:102-110),
  * the stateful `_DelayLine`/`_RunningSum` RTL mirrors (reference
    minn_rtl.py:512-580, zc_v2.py:191-238, sync_aa.py:321-386) and the
    SystemVerilog modules they model (reference ref/minn_delay_line.sv:49-78,
    ref/minn_running_sum.sv:50-99).

All functions operate on the LAST axis and are batch-friendly on leading axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ofdm_sync_tpu.kernels import blocked


def sliding_sum_valid(x: jax.Array, window: int) -> jax.Array:
    """``y[d] = sum_{k=d}^{d+window-1} x[k]`` ("valid" mode).

    Output length is ``L - window + 1`` along the last axis.
    """
    if window <= 0:
        raise ValueError("window must be positive")
    cs = blocked.cumsum(x)
    lead = cs[..., window - 1 : window]  # y[0] = cs[window-1]
    rest = cs[..., window:] - cs[..., :-window]
    return jnp.concatenate([lead, rest], axis=-1)


def running_sum_stream(x: jax.Array, window: int) -> jax.Array:
    """Causal running sum with zero-filled history (RTL semantics).

    ``y[n] = sum_{k=max(0, n-window+1)}^{n} x[k]`` -- exactly the behaviour of
    a hardware running sum whose delay memory powers up at zero (reference
    ref/minn_running_sum.sv:50-99 and its software mirrors, e.g. reference
    ref/test_minn_preamble_detector.py:50-63).  Same length as the input.
    """
    if window <= 0:
        raise ValueError("window must be positive")
    cs = blocked.cumsum(x)
    shifted = shift_right(cs, window)
    return cs - shifted


def shift_right(x: jax.Array, delay: int, fill=0) -> jax.Array:
    """``y[n] = x[n - delay]`` with ``fill`` for ``n < delay``.

    The vectorized equivalent of a depth-``delay`` delay line that reads zeros
    while priming (reference ref/minn_delay_line.sv:58-74, reference
    sync_aa.py:368-386).
    """
    if delay == 0:
        return x
    if delay < 0:
        raise ValueError("delay must be non-negative")
    if delay >= x.shape[-1]:
        # the delay line is still priming at end of stream: all fill
        # (a negative slice stop below would silently GROW the array)
        return jnp.full_like(x, fill)
    prefix = jnp.full(x.shape[:-1] + (delay,), fill, dtype=x.dtype)
    return jnp.concatenate([prefix, x[..., : x.shape[-1] - delay]], axis=-1)


def delayed_product(x: jax.Array, delay: int) -> jax.Array:
    """``u[n] = x[n] * conj(x[n - delay])``, zero for ``n < delay``.

    The lag-product feeding every streaming autocorrelator in the reference
    (reference sync_aa.py:463-471, minn_rtl.py:609-617).
    """
    xd = shift_right(x, delay)
    prod = x * jnp.conj(xd)
    n = jnp.arange(x.shape[-1])
    return jnp.where(n >= delay, prod, jnp.zeros((), dtype=prod.dtype))


def trailing_average(x: jax.Array, window: int) -> jax.Array:
    """Streaming trailing moving average with partial-window warm-up.

    ``y[n] = (sum of the last min(n+1, window) samples) / min(n+1, window)``
    (reference minn.py:115-128, combined_sc_min.py:167-180).
    """
    if window <= 1:
        return x.astype(jnp.result_type(x, jnp.float32))
    rs = running_sum_stream(x, window)
    n = jnp.arange(x.shape[-1])
    denom = jnp.minimum(n + 1, window).astype(rs.dtype)
    return rs / denom


def exp_smooth_shift(
    x: jax.Array, smooth_shift: int, update_mask: jax.Array | None = None
) -> jax.Array:
    """Exponential smoothing ``s += (x - s) / 2**smooth_shift``.

    Mirrors the RTL smoother (reference ref/minn_preamble_detector.sv:277-300,
    minn_rtl.py:706-715).  ``update_mask`` freezes the state where False (the
    RTL `metric_valid` gating).  Implemented as a first-order linear
    recurrence solved with a log-depth associative scan -- no serial loop.
    """
    if smooth_shift < 0:
        raise ValueError("smooth_shift must be non-negative")
    if smooth_shift == 0:
        if update_mask is None:
            return x
        # s passes through x where updating, holds previous value otherwise.
        alpha = update_mask.astype(x.dtype)
    else:
        alpha = jnp.full(x.shape, 1.0 / (1 << smooth_shift), dtype=x.dtype)
        if update_mask is not None:
            alpha = jnp.where(update_mask, alpha, jnp.zeros((), x.dtype))
    return linear_recurrence(1.0 - alpha, alpha * x)


def linear_recurrence(a: jax.Array, b: jax.Array) -> jax.Array:
    """Solve ``s[n] = a[n] * s[n-1] + b[n]`` with ``s[-1] = 0`` in parallel.

    Log-depth associative scan -- the idiomatic XLA form of a sequential IIR
    filter -- two-level blocked for long axes (see kernels.blocked)."""
    return blocked.linear_recurrence(a, b)


def frame_signal(x: jax.Array, num_frames: int, frame_len: int, hop: int = 1,
                 offset: int = 0) -> jax.Array:
    """Gather overlapping frames: ``out[d, k] = x[offset + d*hop + k]``.

    Used by the frequency-domain ZC detector (one FFT window per candidate
    offset, reference zc_freq.py:85-93) and the Park centered correlation.
    """
    d = jnp.arange(num_frames) * hop + offset
    k = jnp.arange(frame_len)
    idx = d[:, None] + k[None, :]
    return x[..., idx]
