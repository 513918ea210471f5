"""Detector timing metrics as pure array programs.

Each function re-derives a reference detector's per-offset loop as windowed
sums (`ops.windows`), producing bit-identical math (up to f32 rounding) with
O(L) parallel work instead of O(L*N) serial Python.

  sc_metric          <- reference sc.py:42-78        (recursive O(1) update)
  minn_metric        <- reference minn.py:59-112     (brute force quarters)
  sc_generic_metric  <- reference combined_sc_min.py:116-164
  minn_rtl_metric    <- reference minn_rtl.py:583-733 / ref/minn_antenna_path.sv
  park_metric        <- reference park.py:64-114
  matched_filter     <- reference zc.py:106-130, zc_v2.py:244-271
  zc_freq_metric     <- reference zc_freq.py:62-99
  aa_metric          <- reference sync_aa.py:421-493
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ofdm_sync_tpu.ops.windows import (
    delayed_product,
    exp_smooth_shift,
    frame_signal,
    running_sum_stream,
    shift_right,
    sliding_sum_valid,
    trailing_average,
)
from ofdm_sync_tpu.ops.detect import earliest_long_run_end, largest_true_run
from ofdm_sync_tpu.ops.channel import fft_convolve_full

_EPS = 1e-12


def _as2d(x: jax.Array) -> jax.Array:
    x = jnp.asarray(x)
    return x[None, :] if x.ndim == 1 else x


# ---------------------------------------------------------------------------
# Schmidl & Cox (reference sc.py:42-78)
# ---------------------------------------------------------------------------

def sc_metric(rx: jax.Array, n_fft: int) -> tuple[jax.Array, jax.Array, jax.Array]:
    """S&C streaming metric M = |P|^2 / R^2 over all window offsets.

    The reference's recursive update (reference sc.py:65-72) unrolls to
    ``P(d) = sum_{k=d}^{d+half-1} x[k] conj(x[k+half])`` and
    ``R(d) = sum_{k=d+half}^{d+N-1} |x[k]|^2`` -- two windowed sums.
    Returns (M, P, R), each of length L - N + 1, branch-summed.
    """
    if n_fft % 2:
        raise ValueError(f"n_fft must be even, got {n_fft}")
    x = _as2d(rx)
    half = n_fft // 2
    L = x.shape[-1]
    out_len = L - n_fft + 1
    if out_len <= 0:
        z = jnp.zeros((0,))
        return z, z.astype(jnp.complex64), z

    u = x[:, :-half] * jnp.conj(x[:, half:])          # lag product, len L-half
    P = jnp.sum(sliding_sum_valid(u, half), axis=0)    # len L-N+1... see below
    P = P[:out_len]
    p = jnp.abs(x) ** 2
    S = sliding_sum_valid(p, half)                     # len L-half+1
    R = jnp.sum(S[:, half : half + out_len], axis=0)

    M = (jnp.abs(P) ** 2) / jnp.maximum(R, _EPS) ** 2
    return M, P, R


def find_plateau_end(
    M: jax.Array,
    cp_len: int,
    lookahead: int | None = None,
    smooth_win: int = 8,
    plateau_frac: float = 0.95,
    run_threshold: float = 0.6,
) -> jax.Array:
    """Plateau-end picker with the reference's 3 fallback strategies
    (reference sc.py:81-146), vectorized:

      1. first sample <= 95% of the smoothed max within cp_len after argmax;
      2. right edge of the earliest >= cp_len/2-long run above 0.6 * peak;
      3. largest smoothed-metric drop over a lookahead window near the max.
    """
    n = M.shape[-1]
    if n == 0:
        return jnp.int32(0)
    Lh = (cp_len // 4) if lookahead is None else max(1, int(lookahead))
    w = max(1, smooth_win)
    kernel = jnp.ones((w,), M.dtype) / w
    Ms = jnp.convolve(M, kernel, mode="same")
    idx = jnp.arange(n, dtype=jnp.int32)

    # --- strategy 1: early drop below plateau_frac * local max ------------
    center = jnp.argmax(Ms).astype(jnp.int32)
    post_hi = jnp.minimum(n, center + cp_len)
    thr_local = plateau_frac * Ms[center]
    in_post = (idx > center) & (idx < post_hi)
    below = in_post & (Ms <= thr_local)
    s1_hit = jnp.any(below) & (post_hi > center + 1)
    s1 = jnp.argmax(below).astype(jnp.int32)  # earliest True

    # --- strategy 2: earliest long run above 0.6 * global max -------------
    min_run = max(8, cp_len // 2)
    peak = jnp.max(Ms)
    hi_mask = (Ms >= run_threshold * peak) & (peak > 0)
    s2 = earliest_long_run_end(hi_mask, min_run)
    s2_hit = s2 >= 0

    # --- strategy 3: slope-drop fallback -----------------------------------
    lo = jnp.maximum(0, center - cp_len)
    hi = jnp.maximum(lo, jnp.minimum(n - Lh - 1, center + cp_len))
    ahead = jnp.concatenate([Ms[Lh:], jnp.zeros((Lh,), Ms.dtype)])
    drop = jnp.where((idx >= lo) & (idx < hi), Ms - ahead, -jnp.inf)
    s3_any = hi > lo
    s3 = jnp.where(s3_any, jnp.argmax(drop).astype(jnp.int32) + Lh // 2, center)

    return jnp.where(s1_hit, s1, jnp.where(s2_hit, s2, s3))


# ---------------------------------------------------------------------------
# Standard Minn [A A -A -A] (reference minn.py:59-112)
# ---------------------------------------------------------------------------

def minn_metric(rx: jax.Array, n_fft: int) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Minn metric: identical-quarter correlations, sign-aligned.

    ``P(d) = <q0,q1> + <q2,q3>``, ``R(d) = |q1|^2+|q2|^2+|q3|^2``,
    ``M = clip(Re P, 0)^2 / R^2``.  The reference recomputes all four
    quarters per offset (reference minn.py:92-104); here
    ``P(d) = Sv(d) + Sv(d+2Q)`` with ``Sv`` one windowed lag-Q product.
    """
    x = _as2d(rx)
    Q = n_fft // 4
    L = x.shape[-1]
    out_len = L - n_fft + 1
    if out_len <= 0:
        z = jnp.zeros((0,))
        return z, z.astype(jnp.complex64), z

    v = x[:, :-Q] * jnp.conj(x[:, Q:])                 # len L-Q
    Sv = sliding_sum_valid(v, Q)                       # len L-2Q+1
    P = jnp.sum(Sv[:, :out_len] + Sv[:, 2 * Q : 2 * Q + out_len], axis=0)

    p = jnp.abs(x) ** 2
    Sp = sliding_sum_valid(p, Q)                       # len L-Q+1
    R = jnp.sum(
        Sp[:, Q : Q + out_len]
        + Sp[:, 2 * Q : 2 * Q + out_len]
        + Sp[:, 3 * Q : 3 * Q + out_len],
        axis=0,
    )
    aligned = jnp.clip(P.real, 0.0, None)
    M = aligned**2 / jnp.maximum(R, _EPS) ** 2
    return M, P, R


def find_minn_peak_standard(
    M: jax.Array,
    smooth_win: int = 8,
    gate_threshold: float = 0.5,
    search_bounds: tuple[int, int] | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Standard-Minn peak finder (reference minn.py:131-205): trailing-average
    smoothing, 0.5*max gate, largest contiguous gate segment, argmax within.
    Returns (peak_idx, gate_mask, smoothed)."""
    n = M.shape[-1]
    Ms = trailing_average(jnp.maximum(M, 0.0), smooth_win)
    max_ms = jnp.max(Ms)
    gate = largest_true_run(Ms >= gate_threshold * max_ms)
    if search_bounds is not None:
        start = max(0, search_bounds[0])
        end = min(n, search_bounds[1])
        if start >= end:
            start, end = 0, n
        idx = jnp.arange(n)
        gate = gate & (idx >= start) & (idx < end)
    # Fallback to global argmax when gating fails (reference minn.py:195-200).
    any_gate = jnp.any(gate) & (max_ms > 0)
    fallback = jnp.zeros_like(gate).at[jnp.argmax(Ms)].set(True)
    gate = jnp.where(any_gate, gate, fallback)
    peak_idx = jnp.argmax(jnp.where(gate, Ms, -jnp.inf)).astype(jnp.int32)
    return peak_idx, gate, Ms


# ---------------------------------------------------------------------------
# Generic-length S&C with both-halves energy (reference combined_sc_min.py:116-164)
# ---------------------------------------------------------------------------

def sc_generic_metric(
    rx: jax.Array, symbol_len: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """S&C variant normalizing by the energy of BOTH halves
    (reference combined_sc_min.py:149-163)."""
    x = _as2d(rx)
    half = symbol_len // 2
    L = x.shape[-1]
    out_len = L - symbol_len + 1
    if half == 0 or out_len <= 0:
        z = jnp.zeros((0,))
        return z, z.astype(jnp.complex64), z
    u = x[:, :-half] * jnp.conj(x[:, half:])
    P = jnp.sum(sliding_sum_valid(u, half)[:, :out_len], axis=0)
    p = jnp.abs(x) ** 2
    Sp = sliding_sum_valid(p, half)
    R = jnp.sum(Sp[:, :out_len] + Sp[:, half : half + out_len], axis=0)
    M = (jnp.abs(P) ** 2) / jnp.maximum(R, _EPS) ** 2
    return M, P, R


# ---------------------------------------------------------------------------
# Minn-RTL adjacent-quarter detector (reference minn_rtl.py:583-733,
# ref/minn_antenna_path.sv:33-194, ref/test_minn_preamble_detector.py:66-147)
# ---------------------------------------------------------------------------

class MinnRTLMetricState(NamedTuple):
    corr_total: jax.Array      # sum over branches of corr_recent + corr_previous
    corr_positive: jax.Array   # clip(corr_total, 0)
    smooth_metric: jax.Array   # exponential smoothing of corr_positive
    energy_total: jax.Array    # 3 stacked Q-window energies per branch
    corr_scaled: jax.Array     # smooth * 2^frac_bits
    energy_scaled: jax.Array   # energy_total * threshold_value
    metric_valid: jax.Array    # bool; True from 3Q-1 on
    above_threshold: jax.Array # metric_valid & (corr_scaled >= energy_scaled)


def antenna_path(x: jax.Array, quarter_len: int) -> dict[str, jax.Array]:
    """Per-branch RTL datapath as shifts + running sums.

    Mirrors ref/minn_antenna_path.sv:33-194 exactly under its zero-fill
    priming semantics: quarter product Re(x[n] conj(x[n-Q])), two Q-window
    running sums, Q-delayed corr tap, Q- and 2Q-delayed energy taps.
    """
    Q = quarter_len
    xd = shift_right(x, Q)
    quarter_product = (x * jnp.conj(xd)).real   # = i*i_d + q*q_d
    power = jnp.abs(x) ** 2
    corr_recent = running_sum_stream(quarter_product, Q)
    energy_recent = running_sum_stream(power, Q)
    return {
        "corr_recent": corr_recent,
        "corr_previous": shift_right(corr_recent, Q),
        "energy_recent": energy_recent,
        "energy_previous": shift_right(energy_recent, Q),
        "energy_previous2": shift_right(energy_recent, 2 * Q),
    }


def minn_rtl_valid_from(quarter_len: int) -> int:
    """First sample index with all taps valid: 3Q-1 (delay-line fill chain,
    reference ref/test_minn_preamble_detector.py:110, minn_rtl.py:512-580)."""
    return max(0, 3 * quarter_len - 1)


def minn_rtl_metric(
    rx: jax.Array,
    *,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    quarter_len: int,
) -> MinnRTLMetricState:
    """Branch-combined fixed-point metric with division-free threshold
    (reference minn_rtl.py:667-733, ref/minn_preamble_detector.sv:247-325)."""
    x = _as2d(rx)
    n = x.shape[-1]
    Q = quarter_len
    taps = antenna_path(x, Q)

    corr_total = jnp.sum(taps["corr_recent"] + taps["corr_previous"], axis=0)
    energy_total = jnp.sum(
        taps["energy_recent"] + taps["energy_previous"] + taps["energy_previous2"],
        axis=0,
    )
    corr_positive = jnp.maximum(corr_total, 0.0)

    valid_from = minn_rtl_valid_from(Q)
    metric_valid = jnp.arange(n) >= valid_from
    smooth = exp_smooth_shift(corr_positive, smooth_shift, update_mask=metric_valid)

    corr_scaled = smooth * (1 << threshold_frac_bits)
    energy_scaled = energy_total * float(threshold_value)
    above = metric_valid & (corr_scaled >= energy_scaled)
    return MinnRTLMetricState(
        corr_total=corr_total,
        corr_positive=corr_positive,
        smooth_metric=smooth,
        energy_total=energy_total,
        corr_scaled=corr_scaled,
        energy_scaled=energy_scaled,
        metric_valid=metric_valid,
        above_threshold=above,
    )


# ---------------------------------------------------------------------------
# Park conjugate-symmetric correlation (reference park.py:64-114)
# ---------------------------------------------------------------------------

def _poly_mul(u: jax.Array, v: jax.Array) -> jax.Array:
    """Batched full linear convolution along the last axis (complex).

    Small operands unroll to shift-adds (cheaper than tiny FFTs); larger ones
    use the same radix-FFT product as `ops.channel.fft_convolve_full`.
    """
    s, t = u.shape[-1], v.shape[-1]
    n = s + t - 1
    if min(s, t) <= 8:
        a, b = (u, v) if s <= t else (v, u)
        out = jnp.zeros(jnp.broadcast_shapes(u.shape[:-1], v.shape[:-1]) + (n,),
                        jnp.result_type(u, v))
        for k in range(a.shape[-1]):
            out = out.at[..., k : k + b.shape[-1]].add(a[..., k : k + 1] * b)
        return out
    return fft_convolve_full(u, v)


def _place_strided(chunks: jax.Array, stride: int, base: int, out_len: int) -> jax.Array:
    """Scatter chunk j (last-2 axis) at output offset ``base + j*stride``.

    Requires chunk length <= stride (placements never overlap), which turns
    the scatter into a pad + reshape -- no gather/scatter ops.
    """
    *lead, J, C = chunks.shape
    assert C <= stride
    flat = jnp.pad(
        chunks, [(0, 0)] * len(lead) + [(0, 0), (0, stride - C)]
    ).reshape(*lead, J * stride)
    flat = jnp.pad(flat, [(0, 0)] * len(lead) + [(base, 0)])
    if flat.shape[-1] < out_len:
        flat = jnp.pad(flat, [(0, 0)] * len(lead) + [(0, out_len - flat.shape[-1])])
    return flat[..., :out_len]


def park_banded_selfconv(x: jax.Array, half: int) -> jax.Array:
    """``P(d) = sum_{k=0}^{half-1} x[d-k] x[d+k]`` for all d, in O(L log half).

    The Park correlation is the even-index diagonal of the *banded* self-
    convolution ``S[m] = sum_{|u-v| <= 2half-2, u+v=m} x[u]x[v]`` via
    ``P(d) = (S[2d] + x[d]^2) / 2`` (SURVEY.md build-plan step 6: Park as an
    FFT self-convolution, replacing the reference's O(L*N) per-offset loop,
    reference park.py:102-113).

    Decompose x into length-``half`` blocks.  On the even output grid every
    pair (u, v) with u+v even has u-v even, so:
      * within-block and adjacent-block pairs are entirely in-band -- their
        full block-pair convolutions are exact (the only out-of-band pairs
        have odd u-v and land on odd outputs, which are discarded);
      * distance-2 block pairs contribute a *triangle* (u_loc >= v_loc + 2),
        evaluated by binary recursion: at each level the cross half-block
        convolution is exact on even outputs, and the two diagonal quadrants
        recurse.  All placements are stride-uniform => pad+reshape, no
        scatters.
    Cost: O(log half) batched FFT convolutions over the stream.

    x: (..., L) complex, ``half`` a power of two.  Returns (..., L) with
    P[d] valid for d in [half, L-half); other positions hold edge partials.
    """
    h = int(half)
    if h & (h - 1):
        raise ValueError(f"park_banded_selfconv requires power-of-two half, got {h}")
    L = x.shape[-1]
    lead = x.shape[:-1]
    nblocks = -(-L // h) + 2  # +2 zero blocks so a+2 lookups stay in range
    Lp = nblocks * h
    xp = jnp.pad(x, [(0, 0)] * len(lead) + [(0, Lp - L)])
    out_len = 2 * Lp

    blocks = xp.reshape(*lead, nblocks, h)
    # r0: within-block pairs (|u-v| <= h-1, always in band)
    S = _place_strided(_poly_mul(blocks, blocks), 2 * h, 0, out_len)
    # r1: adjacent-block pairs (x2 for both orders; the lone out-of-band
    # corner pair has odd u-v -> odd output -> discarded)
    S = S + 2.0 * _place_strided(
        _poly_mul(blocks[..., :-1, :], blocks[..., 1:, :]), 2 * h, h, out_len
    )
    # r2: distance-2 block pairs, triangle u_loc >= v_loc + 2, by recursion.
    s = h // 2
    while s >= 2:
        rows = xp.reshape(*lead, Lp // (2 * s), 2 * s)
        shift = h // s  # rows spanning two blocks
        U = rows[..., : rows.shape[-2] - shift, s:]   # upper halves, block a
        V = rows[..., shift:, :s]                     # lower halves, block a+2
        S = S + 2.0 * _place_strided(
            _poly_mul(U, V), 4 * s, 2 * h + s, out_len
        )
        s //= 2

    even = S[..., ::2]  # S[2d], length Lp
    return (even[..., :L] + x * x) * 0.5


def park_metric(
    rx: jax.Array, n_fft: int
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Centered correlation ``P(d) = sum_k x[d-k] x[d+k]`` over half = N/2.

    Returns (ds, M, P, E) with ds the evaluated centers [half, L-half-1]
    (reference park.py:87-113).  P comes from the banded-FFT self-convolution
    (`park_banded_selfconv`, O(L log half)); E is one windowed sum.  Leading
    batch axes of `rx` beyond the branch axis broadcast through both.
    """
    x = _as2d(rx)
    half = n_fft // 2
    L = x.shape[-1]
    if half == 0 or L < 2 * half + 1:
        z = jnp.zeros((0,))
        return z.astype(jnp.int32), z, z.astype(jnp.complex64), z
    ds = jnp.arange(half, L - half, dtype=jnp.int32)
    if half & (half - 1):
        # non-power-of-two half: direct framed-gather fallback (O(L*half))
        k = jnp.arange(half)
        fwd = frame_signal(x, ds.shape[0], half, hop=1, offset=half)  # x[d+k]
        idx_bwd = ds[:, None] - k[None, :]
        bwd = x[:, idx_bwd]                                           # x[d-k]
        P = jnp.sum(bwd * fwd, axis=(0, -1))
        E = jnp.sum(jnp.abs(fwd) ** 2, axis=(0, -1))
    else:
        P = jnp.sum(park_banded_selfconv(x, half), axis=0)[half : L - half]
        # E(d) = energy of x[d : d+half] -- one windowed sum
        p = jnp.abs(x) ** 2
        E = jnp.sum(sliding_sum_valid(p, half), axis=0)[half : L - half]
    M = (jnp.abs(P) ** 2) / jnp.maximum(E, _EPS) ** 2
    return ds, M, P, E


# ---------------------------------------------------------------------------
# ZC matched filter (time domain) (reference zc.py:106-130, zc_v2.py:244-271)
# ---------------------------------------------------------------------------

def matched_filter(
    rx: jax.Array,
    reference: jax.Array,
    block: int | None = None,
) -> jax.Array:
    """Per-branch full correlation with the conjugate-reversed reference.

    block: overlap-save block size (batched small FFTs) for long streams;
    None keeps the monolithic bit-parity form the reference pipelines are
    asserted against."""
    x = _as2d(rx)
    ref = jnp.asarray(reference, x.dtype)
    taps = jnp.conj(ref[::-1])
    if block is not None:
        from ofdm_sync_tpu.ops.channel import fft_convolve_full_ols

        return fft_convolve_full_ols(x, taps, block)
    return fft_convolve_full(x, taps[None, :])


def sliding_energy_full(rx: jax.Array, window: int) -> jax.Array:
    """``conv(|x|^2, ones(window), 'full')`` -- the normalization denominator
    (reference zc.py:117, zc_v2.py:266-268)."""
    x = _as2d(rx)
    p = jnp.abs(x) ** 2
    out_len = p.shape[-1] + window - 1
    padded = jnp.pad(p, [(0, 0)] * (p.ndim - 1) + [(window - 1, window - 1)])
    cs = jnp.cumsum(padded, axis=-1)
    lead = cs[..., window - 1 : window]
    rest = cs[..., window:] - cs[..., :-window]
    return jnp.concatenate([lead, rest], axis=-1)[..., :out_len]


def zc_normalized_correlation(
    rx: jax.Array, reference: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Branch-summed normalized matched-filter output, plus its magnitude.

    zc.py flavour (reference zc.py:106-128): numerators and branch powers are
    summed across branches BEFORE normalization.
    """
    x = _as2d(rx)
    ref = jnp.asarray(reference)
    num = jnp.sum(matched_filter(x, ref), axis=0)
    power = jnp.sum(sliding_energy_full(x, ref.shape[-1]), axis=0)
    ref_norm = jnp.sqrt(jnp.sum(jnp.abs(ref) ** 2))
    denom = ref_norm * jnp.sqrt(jnp.maximum(power, 0.0) + _EPS)
    corr = num / denom
    return corr, jnp.abs(corr)


def zc_normalized_correlation_per_branch(
    rx: jax.Array, reference: jax.Array, block: int | None = None
) -> jax.Array:
    """zc_v2 flavour: normalize per branch, THEN sum branches
    (reference zc_v2.py:486-498).  rx: (..., branches, L) or (L,); returns
    the branch-summed complex corr.  `block` as in `matched_filter`."""
    x = _as2d(rx)
    ref = jnp.asarray(reference)
    num = matched_filter(x, ref, block)
    power = sliding_energy_full(x, ref.shape[-1])
    ref_norm = jnp.sqrt(jnp.sum(jnp.abs(ref) ** 2))
    denom = ref_norm * jnp.sqrt(jnp.maximum(power, _EPS))
    return jnp.sum(num / denom, axis=-2)


# ---------------------------------------------------------------------------
# ZC frequency-domain metric (reference zc_freq.py:54-99)
# ---------------------------------------------------------------------------

def zc_freq_metric(
    rx: jax.Array,
    template_bins: jax.Array,
    bin_indices,
    n_fft: int,
    cp_len: int,
    chunk: int = 512,
) -> jax.Array:
    """LTE-style frequency metric at every CP-start offset.

    The reference runs one Python FFT per offset (reference zc_freq.py:85-97);
    here offsets are framed and FFT'd in batched chunks (one batched radix
    FFT per chunk keeps peak memory at chunk * N_FFT).
    """
    x = _as2d(rx)
    L = x.shape[-1]
    usable = n_fft + cp_len
    num_offsets = L - usable + 1
    if num_offsets <= 0:
        raise ValueError("Received stream is shorter than a single OFDM symbol.")
    positions = (n_fft // 2 + jnp.asarray(bin_indices)) % n_fft
    template = jnp.asarray(template_bins, jnp.complex64)
    template_energy = jnp.sum(jnp.abs(template) ** 2)

    pad = (-num_offsets) % chunk
    starts = jnp.arange(num_offsets + pad, dtype=jnp.int32).reshape(-1, chunk)
    # gathers run on PLANAR float planes (bit-identical values)
    xp = jnp.stack([x.real, x.imag])  # (2, B, L), dtype follows the input

    def do_chunk(offsets):
        o = jnp.minimum(offsets, max(num_offsets - 1, 0))
        k = jnp.arange(n_fft)
        wp = xp[:, :, o[:, None] + cp_len + k[None, :]]  # (2, B, chunk, N)
        windows = wp[0] + 1j * wp[1]
        spec = jnp.fft.fftshift(jnp.fft.fft(windows, axis=-1), axes=-1)
        sp = jnp.stack([spec.real, spec.imag])
        bp = sp[..., positions]                          # (2, B, chunk, 62)
        bins = bp[0] + 1j * bp[1]
        corr = jnp.sum(jnp.conj(template)[None, None, :] * bins, axis=(0, -1))
        energy = jnp.sum(bp[0] * bp[0] + bp[1] * bp[1], axis=(0, -1))
        denom = jnp.maximum(template_energy * energy, _EPS)
        return (corr.real**2 + corr.imag**2) / denom

    metric = jax.lax.map(do_chunk, starts).reshape(-1)
    return metric[:num_offsets]


def zc_freq_metric_sliding(
    rx: jax.Array,
    template_bins: jax.Array,
    bin_indices,
    n_fft: int,
    cp_len: int,
) -> jax.Array:
    """Streaming form of `zc_freq_metric`: sliding DFT bins as
    windowed sums.

    The reference evaluates a full N-point FFT at every CP-start offset
    (reference zc_freq.py:85-97) but only reads ~62 template bins of it.
    Each bin is algebraically a windowed sum of a modulated stream:

        X_o[k] = sum_m x[o+cp+m] w_k^m  =  w_k^{-(o+cp)} * S_k[o+cp],
        S_k[t] = sum_{n=t}^{t+N-1} x[n] w_k^n,   w_k = exp(-2j pi k / N)

    so the whole search is |bins| modulate-and-window-sum passes -- no
    per-offset FFTs, no window gathers, O(L * n_bins) instead of
    O(L * N log N).  Phasors use n mod N (exact periodicity keeps the
    trig arguments small), and the energy term needs no un-rotation at
    all (|X| = |S|).  Matches `zc_freq_metric` up to f32 accumulation
    (the window sums are cumsum-based; tests assert tolerance + peak
    equality).
    """
    x = _as2d(rx)
    L = x.shape[-1]
    usable = n_fft + cp_len
    num_offsets = L - usable + 1
    if num_offsets <= 0:
        raise ValueError("Received stream is shorter than a single OFDM symbol.")
    template = jnp.asarray(template_bins, jnp.complex64)
    template_energy = jnp.sum(jnp.abs(template) ** 2)
    # natural FFT bin indices: fftshifted position (N/2 + b) % N reads
    # FFT bin b % N
    kbins = jnp.asarray(np.mod(np.asarray(bin_indices), n_fft), jnp.int32)

    n_idx = jnp.arange(L, dtype=jnp.int32)
    o_idx = jnp.arange(num_offsets, dtype=jnp.int32) + cp_len
    two_pi_over_n = jnp.float32(2.0 * np.pi / n_fft)

    # reduce indices mod N BEFORE the multiply so k*(n mod N) < N^2 < 2^31
    # stays exact in int32 for ANY stream length (k*n itself would wrap
    # past ~1M samples)
    n_mod = n_idx % n_fft
    o_mod = o_idx % n_fft

    def per_bin(carry, kt):
        corr, energy = carry
        k, T = kt
        ph_arg = two_pi_over_n * ((k * n_mod) % n_fft).astype(jnp.float32)
        ph = jnp.exp(-1j * ph_arg)                              # w_k^n
        S = sliding_sum_valid(x * ph, n_fft)                    # (B, L-N+1)
        Sb = S[:, cp_len : cp_len + num_offsets]
        un_arg = two_pi_over_n * ((k * o_mod) % n_fft).astype(jnp.float32)
        unrot = jnp.exp(1j * un_arg)                            # w_k^-(o+cp)
        corr = corr + jnp.conj(T) * unrot * jnp.sum(Sb, axis=0)
        energy = energy + jnp.sum(Sb.real**2 + Sb.imag**2, axis=0)
        return (corr, energy), None

    z = jnp.zeros((num_offsets,), jnp.complex64)
    (corr, energy), _ = jax.lax.scan(
        per_bin,
        (z, jnp.zeros((num_offsets,), jnp.float32)),
        (kbins, template),
    )
    denom = jnp.maximum(template_energy * energy, _EPS)
    return (corr.real**2 + corr.imag**2) / denom


# ---------------------------------------------------------------------------
# [A][A] streaming detector metric (reference sync_aa.py:421-493)
# ---------------------------------------------------------------------------

class AAMetricState(NamedTuple):
    P: jax.Array        # complex correlation, running L-window of lag-L product
    R: jax.Array        # current-window energy
    M: jax.Array        # clip(|P|^2 / R^2, <=1), 0 where invalid
    valid: jax.Array    # bool, True from n >= L


def aa_metric(rx: jax.Array, L: int) -> AAMetricState:
    """Causal streaming [A][A] metric with RTL fill semantics.

    ``P[n] = sum_{k=n-L+1}^{n} x[k] conj(x[k-L])`` (zero products while the
    delay line primes), ``R[n]`` the energy of the CURRENT window
    (reference sync_aa.py:458-493).  Valid from n >= L.
    """
    x = _as2d(rx)
    n = x.shape[-1]
    prod = delayed_product(x, L)
    P = jnp.sum(running_sum_stream(prod, L), axis=0)
    R = jnp.sum(running_sum_stream(jnp.abs(x) ** 2, L), axis=0)
    valid = jnp.arange(n) >= L
    noise_floor = 1e-6 * L
    M = jnp.where(
        valid & (R > noise_floor),
        jnp.minimum((jnp.abs(P) ** 2) / jnp.maximum(R, _EPS) ** 2, 1.0),
        0.0,
    )
    return AAMetricState(P=P, R=R, M=M, valid=valid)
