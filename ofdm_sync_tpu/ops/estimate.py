"""Estimation: CFO (4 CP-correlation variants), LS channel, equalization,
EVM, and residual-timing-from-phase-slope.

Vectorized re-expression of reference core.py:179-469.  The reference's
per-offset Python loops over CP correlations (reference core.py:224-228,
258-262, 292-300, 328-333) all reduce to ONE shared primitive: the
branch-summed lag-N_FFT product followed by a windowed sum -- computed once,
vectorized, then aggregated / arg-maxed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ofdm_sync_tpu.ops.windows import sliding_sum_valid
from ofdm_sync_tpu.ops.waveforms import centered_subcarrier_indices

_EPS = 1e-12


def _as2d(x: jax.Array) -> jax.Array:
    x = jnp.asarray(x)
    return x[None, :] if x.ndim == 1 else x


def cp_correlation_profile(rx: jax.Array, n_fft: int, win: int) -> jax.Array:
    """``P(d) = sum_b sum_{n<win} rx[b, d+n] * conj(rx[b, d+n_fft+n])``
    for every d -- the shared core of all CP-based CFO estimators
    (reference core.py:190-193 evaluated at all offsets at once)."""
    x = _as2d(rx)
    w = jnp.sum(x[:, :-n_fft] * jnp.conj(x[:, n_fft:]), axis=0)
    return sliding_sum_valid(w, win)


def cfo_from_P(P: jax.Array, n_fft: int, fs_hz: float) -> jax.Array:
    """``cfo = -angle(P) * fs / (2 pi N)`` (reference core.py:194-196)."""
    return -jnp.angle(P) * fs_hz / (2 * jnp.pi * n_fft)


def estimate_cfo_from_cp(
    rx: jax.Array, start: int, n_fft: int, cp_len: int, fs_hz: float
) -> jax.Array:
    """Single-window CP CFO estimate (reference core.py:179-196)."""
    x = _as2d(rx)
    a = jax.lax.dynamic_slice_in_dim(x, start, cp_len, axis=1)
    b = jax.lax.dynamic_slice_in_dim(x, start + n_fft, cp_len, axis=1)
    P = jnp.sum(a * jnp.conj(b))
    return cfo_from_P(P, n_fft, fs_hz)


def _span_bounds(L: int, cp_start_est: int, n_fft: int, win: int, span: int):
    """[d_lo, d_hi) search bounds.  NOTE: d_hi is EXCLUSIVE and capped at
    L - (n_fft + win), so the very last valid offset is never searched --
    this reproduces the reference's own loop bound exactly
    (reference core.py:221-226, 331-333); do not "fix" it, parity depends
    on it."""
    d_lo = max(0, cp_start_est - span)
    d_hi = min(L - (n_fft + win), cp_start_est + span)
    return d_lo, d_hi


def estimate_cfo_from_cp_robust(
    rx: jax.Array,
    cp_start_est: int,
    n_fft: int,
    cp_len: int,
    fs_hz: float,
    span: int | None = None,
    win_len: int | None = None,
) -> jax.Array:
    """Aggregate P(d) over d in +-span with a short window
    (reference core.py:199-231)."""
    x = _as2d(rx)
    L = x.shape[1]
    span = cp_len // 2 if span is None else int(max(0, span))
    win = cp_len // 2 if win_len is None else int(max(1, win_len))
    d_lo, d_hi = _span_bounds(L, cp_start_est, n_fft, win, span)
    if d_hi <= d_lo:
        return estimate_cfo_from_cp(x, cp_start_est, n_fft, min(cp_len, win), fs_hz)
    P = cp_correlation_profile(x, n_fft, win)
    P_acc = jnp.sum(P[d_lo:d_hi])
    return cfo_from_P(P_acc, n_fft, fs_hz)


def estimate_cfo_from_cp_peak_with_index(
    rx: jax.Array,
    cp_start_est: int,
    n_fft: int,
    cp_len: int,
    fs_hz: float,
    span: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Pick the CP offset maximizing |P(d)| near the estimate; return
    (cfo, best_d) (reference core.py:271-303)."""
    x = _as2d(rx)
    L = x.shape[1]
    span = cp_len // 2 if span is None else int(max(0, span))
    d_lo, d_hi = _span_bounds(L, cp_start_est, n_fft, cp_len, span)
    if d_hi <= d_lo:
        return (
            estimate_cfo_from_cp(x, cp_start_est, n_fft, cp_len, fs_hz),
            jnp.asarray(cp_start_est),
        )
    P = cp_correlation_profile(x, n_fft, cp_len)[d_lo:d_hi]
    best = jnp.argmax(jnp.abs(P))
    return cfo_from_P(P[best], n_fft, fs_hz), d_lo + best


def estimate_cfo_from_cp_peak(
    rx: jax.Array,
    cp_start_est: int,
    n_fft: int,
    cp_len: int,
    fs_hz: float,
    span: int | None = None,
) -> jax.Array:
    """As above but returns only the CFO (reference core.py:234-268)."""
    cfo, _ = estimate_cfo_from_cp_peak_with_index(
        rx, cp_start_est, n_fft, cp_len, fs_hz, span
    )
    return cfo


def find_cp_start_via_corr(
    rx: jax.Array, est_start: int, n_fft: int, cp_len: int, search_half: int = 1024
) -> int:
    """Refine CP start by maximizing |P(d)| over +-search_half
    (reference core.py:306-336)."""
    x = _as2d(rx)
    L = x.shape[1]
    lo = max(0, est_start - search_half)
    hi = min(L - (n_fft + cp_len), est_start + search_half)
    if hi <= lo:
        return est_start
    P = cp_correlation_profile(x, n_fft, cp_len)[lo:hi]
    return int(lo + jnp.argmax(jnp.abs(P)))


# ---------------------------------------------------------------------------
# LS channel estimate / equalization / EVM (reference core.py:339-370)
# ---------------------------------------------------------------------------

def ls_channel_estimate(y_used: jax.Array, x_used: jax.Array, eps: float = 1e-9) -> jax.Array:
    return y_used / (x_used + eps)


def equalize(y_used: jax.Array, h_est: jax.Array, eps: float = 1e-9) -> jax.Array:
    return y_used / (h_est + eps)


def remove_common_phase(
    x: jax.Array, ref: jax.Array | None = None
) -> tuple[jax.Array, jax.Array]:
    """De-rotate by common phase error (reference core.py:348-354)."""
    if ref is None:
        cpe = jnp.angle(jnp.mean(x))
    else:
        cpe = jnp.angle(jnp.vdot(ref, x) / (jnp.vdot(ref, ref) + _EPS))
    return x * jnp.exp(-1j * cpe), cpe


def align_complex_gain(
    x: jax.Array, ref: jax.Array, eps: float = _EPS
) -> tuple[jax.Array, jax.Array]:
    """LS complex gain g minimizing ||g x - ref||^2 (reference core.py:357-362)."""
    g = jnp.vdot(x, ref) / (jnp.vdot(x, x) + eps)
    return x * g, g


def evm_rms_db(x: jax.Array, ref: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(evm_rms, evm_db), normalized to reference RMS (reference core.py:365-370)."""
    err = x - ref
    evm_rms = jnp.sqrt(jnp.mean(jnp.abs(err) ** 2) / jnp.mean(jnp.abs(ref) ** 2))
    return evm_rms, 20 * jnp.log10(evm_rms + _EPS)


# ---------------------------------------------------------------------------
# Residual timing from phase slope (reference core.py:443-469)
# ---------------------------------------------------------------------------

def estimate_timing_offset_from_phase_slope(
    h_used: jax.Array, n_fft: int, num_active: int
) -> tuple[jax.Array, jax.Array]:
    """Linear fit of unwrapped angle(H(k)) vs k; Delta = -slope * N / (2 pi).

    Returns (slope rad/bin, timing offset in samples)."""
    h = jnp.asarray(h_used)
    k = jnp.asarray(centered_subcarrier_indices(num_active), dtype=jnp.float32)
    phi = jnp.unwrap(jnp.angle(h))
    k0 = k - jnp.mean(k)
    phi0 = phi - jnp.mean(phi)
    slope = jnp.sum(k0 * phi0) / (jnp.sum(k0 * k0) + _EPS)
    return slope, -slope * n_fft / (2.0 * jnp.pi)


def reconstruct_cir_from_ls(h_used: jax.Array, n_fft: int, num_active: int) -> jax.Array:
    """Rebuild a time-domain CIR from a per-subcarrier LS estimate
    (reference minn.py:208-219)."""
    idx = centered_subcarrier_indices(num_active)
    spectrum = jnp.zeros(n_fft, dtype=jnp.complex64)
    spectrum = spectrum.at[(n_fft // 2 + idx) % n_fft].set(jnp.asarray(h_used, jnp.complex64))
    return jnp.fft.ifft(jnp.fft.ifftshift(spectrum))
