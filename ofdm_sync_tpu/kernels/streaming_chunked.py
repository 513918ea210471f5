"""Chunked streaming detection with explicit carried state.

The RTL detector is a streaming device: it consumes an endless IQ stream and
carries all its state in delay lines, running sums, the smoothing register,
and the gate FSM (reference ref/minn_preamble_detector.sv).  This module
exposes those carries *between* calls, so a receiver can process an
unbounded stream chunk-by-chunk (or checkpoint/resume mid-stream -- the state
is a plain pytree, serializable with orbax):

    state = minn_rtl_stream_init(params, branches=2)
    for chunk in stream:                       # (branches, 2, chunk_len)
        state = minn_rtl_stream_step(state, chunk)
    events = minn_rtl_stream_finalize(state)   # GateEvents, == one-shot

Exactness: feeding the concatenation of all chunks to
`minn_rtl_detect_planar` yields the same event table bit-for-bit (tests
assert this for random chunk splits) up to float reassociation inside a
chunk.  The cross-chunk carry is the same closed form the fused kernel uses
between its blocks (kernels/minn_rtl_triton.py): (last-above index, #gates)
plus per-slot (start, last_above, peak_idx, peak_value).

Index horizon: global sample indices are int32 (the device's native width, the same
class of finite counter the RTL carries in its pointers), so one epoch spans
2^31 samples (~70 s at 30.72 Msps).  A live receiver calls
`minn_rtl_stream_rebase` after consuming events -- well before the horizon
-- to start a fresh epoch while keeping the IQ/smoothing carries; event
indices are then relative to the rebase point.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ofdm_sync_tpu.ops.detect import GateEvents
from ofdm_sync_tpu.ops.windows import shift_right

_I32_MAX = jnp.iinfo(jnp.int32).max
_NEG_INF = float("-inf")

# Hard bound of one index epoch: global sample indices are int32, so
# state.base + chunk_len must stay strictly below this or indices wrap (~70 s
# of stream at 30.72 Msps).  Call `minn_rtl_stream_rebase` on a quiet stretch
# before the headroom runs out; `epoch_headroom` is the host-side check.
EPOCH_HORIZON = 2**31 - 2
_EPOCH_WARN_MARGIN = 1 << 28  # ~268M samples (~8.7 s at 30.72 Msps)


def epoch_headroom(state, *, warn_margin: int = _EPOCH_WARN_MARGIN) -> int:
    """Samples left in the current int32 index epoch (host-side guard).

    Works on any stream state with a `.base` field.  Warns when headroom
    drops under `warn_margin` and raises once the epoch is exhausted --
    a continuously running receiver calls this between chunks (it is a
    host-side check; `state.base` must be concrete, not a tracer) and
    invokes `minn_rtl_stream_rebase` on a quiet stretch well before
    the horizon.
    """
    import warnings

    import numpy as np

    base = int(np.asarray(state.base))
    headroom = EPOCH_HORIZON - base
    if headroom <= 0:
        raise OverflowError(
            f"int32 index epoch exhausted (base={base} >= {EPOCH_HORIZON}); "
            "indices from further chunks would wrap -- rebase the stream "
            "state (minn_rtl_stream_rebase) on a quiet stretch before this "
            "point"
        )
    if headroom < warn_margin:
        warnings.warn(
            f"index epoch nearly exhausted ({headroom} samples of headroom "
            f"left before {EPOCH_HORIZON}); rebase the stream state on the "
            "next quiet stretch",
            RuntimeWarning,
            stacklevel=2,
        )
    return headroom


class MinnRTLStreamParams(NamedTuple):
    quarter_len: int
    smooth_shift: int
    threshold_value: int
    threshold_frac_bits: int
    hysteresis: int
    max_events: int = 8
    tie: str = "last"


class MinnRTLStreamState(NamedTuple):
    """Everything the detector carries between chunks (a JAX pytree)."""

    hist: jax.Array          # (branches, 2, 3Q) planar IQ tail
    smooth: jax.Array        # f32 scalar -- smoothing register
    base: jax.Array          # i32 scalar -- global index of the next sample
    last_above: jax.Array    # i32 scalar -- global index of last above (-1)
    gate_count: jax.Array    # i32 scalar -- gates opened so far
    ev_start: jax.Array      # i32 (E,)
    ev_last: jax.Array       # i32 (E,) last above per gate
    ev_pidx: jax.Array       # i32 (E,)
    ev_pval: jax.Array       # f32 (E,)


def minn_rtl_stream_init(
    params: MinnRTLStreamParams, branches: int
) -> MinnRTLStreamState:
    Q = params.quarter_len
    E = params.max_events
    tie_last = params.tie == "last"
    return MinnRTLStreamState(
        hist=jnp.zeros((branches, 2, 3 * Q), jnp.float32),
        smooth=jnp.zeros((), jnp.float32),
        base=jnp.zeros((), jnp.int32),
        last_above=jnp.full((), -1, jnp.int32),
        gate_count=jnp.zeros((), jnp.int32),
        ev_start=jnp.full((E,), _I32_MAX, jnp.int32),
        ev_last=jnp.full((E,), -1, jnp.int32),
        ev_pidx=jnp.full((E,), -1 if tie_last else _I32_MAX, jnp.int32),
        ev_pval=jnp.full((E,), _NEG_INF, jnp.float32),
    )


@functools.partial(jax.jit, static_argnames=("params",))
def minn_rtl_stream_step(
    state: MinnRTLStreamState,
    chunk: jax.Array,
    *,
    params: MinnRTLStreamParams,
) -> MinnRTLStreamState:
    """Consume one planar chunk (branches, 2, n); return the updated state.

    n may vary between calls (each distinct n compiles once).
    """
    Q = params.quarter_len
    H = 3 * Q
    h = max(int(params.hysteresis), 1)
    E = params.max_events
    tie_last = params.tie == "last"
    alpha = (
        1.0 / (1 << params.smooth_shift) if params.smooth_shift > 0 else 1.0
    )
    valid_from = max(0, 3 * Q - 1)
    n = chunk.shape[-1]

    ext = jnp.concatenate([state.hist, chunk.astype(jnp.float32)], axis=-1)
    new_hist = ext[..., -H:]

    # metric datapath (same algebra as the fused kernel's block loop);
    # the delay-line primitive is the shared zero-primed shift
    tap = shift_right

    i = ext[..., 0, :]
    q = ext[..., 1, :]
    u = jnp.sum(i * tap(i, Q) + q * tap(q, Q), axis=0)
    p = jnp.sum(i * i + q * q, axis=0)

    def win(x):
        cs = jnp.cumsum(x, axis=-1)
        return cs - tap(cs, Q)

    corr = win(u)
    energy = win(p)
    corr_total = (corr + tap(corr, Q))[H:]
    energy_total = (energy + tap(energy, Q) + tap(energy, 2 * Q))[H:]
    corr_pos = jnp.maximum(corr_total, 0.0)

    # NOTE: window sums here restart from the ext start; positions needing
    # deeper history than 3Q do not exist (max lag is 3Q-1), so emitted
    # values are exact for every chunk after the first, and the first chunk
    # reproduces the RTL zero-priming.
    gi = state.base + jnp.arange(n, dtype=jnp.int32)
    metric_valid = gi >= valid_from

    a = jnp.where(metric_valid, 1.0 - alpha, 1.0).astype(jnp.float32)
    b = jnp.where(metric_valid, alpha * corr_pos, 0.0)

    # associative-scan form (log-depth) with the carried register
    def combine(l, r):
        return (l[0] * r[0], l[1] * r[0] + r[1])

    A, Bv = jax.lax.associative_scan(combine, (a, b))
    smooth = A * state.smooth + Bv
    new_smooth = smooth[-1]

    scaled = smooth * (1 << params.threshold_frac_bits)
    above = metric_valid & (scaled >= energy_total * float(params.threshold_value))

    # --- event carry merge (the fused kernel's per-block event update)
    track = corr_pos
    above_idx = jnp.where(above, gi, jnp.int32(-1))
    la_local = jax.lax.cummax(above_idx, axis=0)
    last_above = jnp.maximum(la_local, state.last_above)
    prev_above = jnp.maximum(
        jnp.concatenate([jnp.full((1,), -1, jnp.int32), la_local[:-1]]),
        state.last_above,
    )
    new_cluster = above & ((prev_above < 0) | (gi - prev_above > h))
    cluster_id = state.gate_count + jnp.cumsum(new_cluster.astype(jnp.int32))
    in_gate = (last_above >= 0) & (gi - last_above <= h) & (cluster_id >= 1)

    ev_start, ev_last = state.ev_start, state.ev_last
    ev_pidx, ev_pval = state.ev_pidx, state.ev_pval
    slots = jnp.arange(E, dtype=jnp.int32)
    neg_inf = jnp.float32(_NEG_INF)
    for c in range(1, E + 1):
        m = in_gate & (cluster_id == c)
        bstart = jnp.min(jnp.where(m, gi, jnp.int32(_I32_MAX)))
        # argmax-based selection (NOT `track == max(track)`: XLA may
        # duplicate `track`'s computation across fusions with different
        # FMA contraction, and the bitwise equality then never holds --
        # see ops/detect.py extract_gate_events)
        masked = jnp.where(m, track, neg_inf)
        nloc = masked.shape[-1]
        if tie_last:
            ji = jnp.int32(nloc - 1) - jnp.argmax(
                masked[::-1]
            ).astype(jnp.int32)
        else:
            ji = jnp.argmax(masked).astype(jnp.int32)
        bpv = masked[ji]
        any_m = jnp.any(m)
        if tie_last:
            bidx = jnp.where(any_m, gi[ji], jnp.int32(-1))
        else:
            bidx = jnp.where(any_m, gi[ji], jnp.int32(_I32_MAX))
        blast = jnp.max(jnp.where(above & (cluster_id == c), gi, jnp.int32(-1)))
        sel = slots == (c - 1)
        ev_start = jnp.where(sel, jnp.minimum(ev_start, bstart), ev_start)
        ev_last = jnp.where(sel, jnp.maximum(ev_last, blast), ev_last)
        cur = ev_pval
        if tie_last:
            take = (bpv > cur) | ((bpv == cur) & (bpv > neg_inf))
        else:
            take = bpv > cur
        ev_pval = jnp.where(sel, jnp.maximum(cur, bpv), cur)
        ev_pidx = jnp.where(sel & take, bidx, ev_pidx)

    return MinnRTLStreamState(
        hist=new_hist,
        smooth=new_smooth,
        base=state.base + n,
        last_above=last_above[-1],
        gate_count=cluster_id[-1],
        ev_start=ev_start,
        ev_last=ev_last,
        ev_pidx=ev_pidx,
        ev_pval=ev_pval,
    )


def minn_rtl_stream_rebase(
    state: MinnRTLStreamState, *, params: MinnRTLStreamParams
) -> MinnRTLStreamState:
    """Start a fresh index epoch: clear the event table and zero the global
    sample counter, keeping the IQ tail, smoothing register, and warm-up
    (the physical stream state).

    Call after consuming `minn_rtl_stream_finalize`'s events, well before
    the 2^31-sample int32 horizon (~70 s at 30.72 Msps).  The counter
    restarts at 3Q-1 (the stream is already warmed up, so every
    post-rebase sample stays metric-valid); an event index ``gi`` maps to
    ``rebase_point + gi - (3Q - 1)`` globally.  A gate still open at the
    rebase point is dropped -- rebase on a quiet stretch (no above samples
    within the hysteresis window), as a real receiver's periodic re-arm
    does.
    """
    E = params.max_events
    tie_last = params.tie == "last"
    # base restarts past the warm-up: the stream has been running, so the
    # metric stays valid from the first post-rebase sample
    valid_from = max(0, 3 * params.quarter_len - 1)
    return MinnRTLStreamState(
        hist=state.hist,
        smooth=state.smooth,
        base=jnp.asarray(valid_from, jnp.int32),
        last_above=jnp.full((), -1, jnp.int32),
        gate_count=jnp.zeros((), jnp.int32),
        ev_start=jnp.full((E,), _I32_MAX, jnp.int32),
        ev_last=jnp.full((E,), -1, jnp.int32),
        ev_pidx=jnp.full((E,), -1 if tie_last else _I32_MAX, jnp.int32),
        ev_pval=jnp.full((E,), _NEG_INF, jnp.float32),
    )


def minn_rtl_stream_finalize(
    state: MinnRTLStreamState, *, params: MinnRTLStreamParams,
    emit_unclosed: bool = False,
) -> GateEvents:
    """Event table for the stream consumed so far (state is NOT consumed --
    you can finalize mid-stream and keep feeding chunks)."""
    h = max(int(params.hysteresis), 1)
    E = params.max_events
    n = state.base  # stream length so far
    slots = jnp.arange(E, dtype=jnp.int32)
    exists = slots < jnp.minimum(state.gate_count, E)
    close_raw = state.ev_last + h
    closed = (close_raw <= n - 1) & exists
    valid = exists if emit_unclosed else (exists & closed)
    z = jnp.int32(0)
    return GateEvents(
        valid=valid,
        closed=closed,
        gate_start=jnp.where(exists, state.ev_start, z),
        gate_close=jnp.where(exists, jnp.clip(close_raw, 0, n - 1), z),
        peak_idx=jnp.where(exists, state.ev_pidx, z),
        peak_value=jnp.where(exists, state.ev_pval, jnp.float32(0.0)),
        count=jnp.sum(valid.astype(jnp.int32)),
        overflow=state.gate_count > E,
    )
