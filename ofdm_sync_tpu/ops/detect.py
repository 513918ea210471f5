"""Gate / hysteresis / peak-tracking detection -- fully parallel.

The reference implements detection three times as sequential per-sample FSMs
(reference minn_rtl.py:750-825, zc_v2.py:360-450, sync_aa.py:495-568; RTL
form in reference ref/minn_preamble_detector.sv:337-384).  A naive port would
be a `lax.scan` over every sample -- the one thing that serializes an
accelerator.

Key observation: the FSM's semantics are *closed-form*.  All three variants
share one rule: a gate opens at an above-threshold sample (when no gate is
open) and closes at the h-th consecutive below-threshold sample.  Therefore

  * gates  == clusters of above-runs whose gaps are  <= h  samples,
  * close  == (last above of the cluster) + h,
  * peak   == arg-max of the tracked value over [gate_start, close].

Clusters fall out of a running maximum (cummax of above-sample indices) and
per-gate reductions are `jax.ops.segment_*` with a static event capacity --
zero sequential steps, O(L) work, log-depth.

Variant differences are parameterized:
  * which array is peak-tracked (smoothed corr / |corr| / |P|^2),
  * tie-breaking ('last' for the RTL `>=` update reference minn_rtl.py:783,
    'first' for the `>` updates reference zc_v2.py:411, sync_aa.py:522),
  * whether a gate still open at end-of-stream emits an event
    (yes: reference zc_v2.py:434-444, sync_aa.py:556-568;
     no: reference minn_rtl.py:814-815).

Validity warm-up is a prefix in this framework (first valid metric at
3Q-1 etc.); callers mask `above` below `valid_from`, which reproduces the
FSMs' "skip invalid samples" behaviour exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ofdm_sync_tpu.kernels import blocked

_I32_MAX = jnp.iinfo(jnp.int32).max


class GateEvents(NamedTuple):
    """Fixed-capacity event table (capacity = static `max_events`)."""

    valid: jax.Array       # bool[max_events]  -- event emitted
    closed: jax.Array      # bool[max_events]  -- gate closed before stream end
    gate_start: jax.Array  # int32[max_events] -- index where gate opened
    gate_close: jax.Array  # int32[max_events] -- h-th-below index (clipped to n-1
    #                           for unclosed gates; see `closed`)
    peak_idx: jax.Array    # int32[max_events]
    peak_value: jax.Array  # track dtype[max_events]
    count: jax.Array       # int32 scalar -- number of valid events
    overflow: jax.Array    # bool scalar -- more gates occurred than capacity


def extract_gate_events(
    above: jax.Array,
    track: jax.Array,
    *,
    hysteresis: int,
    max_events: int = 8,
    valid_from: int = 0,
    tie: str = "first",
    emit_unclosed: bool = True,
) -> GateEvents:
    """Parallel equivalent of the reference gate/peak FSMs (see module doc).

    Args:
      above: boolean per-sample threshold comparison.
      track: per-sample value whose in-gate maximum defines the peak.
      hysteresis: gate closes at the ``max(hysteresis, 1)``-th consecutive
        below sample (all three reference variants share this once their
        counter conventions are unfolded).
      valid_from: samples before this index are skipped (warm-up prefix).
      tie: 'first' -> earliest max wins (``>`` update); 'last' -> latest
        (``>=`` update).
      emit_unclosed: emit an event for a gate still open at end of stream.
    """
    n = above.shape[-1]
    h = max(int(hysteresis), 1)
    if tie not in ("first", "last"):
        raise ValueError("tie must be 'first' or 'last'")
    if n == 0:
        # empty stream -> empty table (the per-slot reductions below have no
        # identity on zero-size arrays); mirrors the metrics' empty-input
        # convention (sc_metric/minn_metric return empty arrays)
        E = max_events
        zi = jnp.zeros((E,), jnp.int32)
        return GateEvents(
            valid=jnp.zeros((E,), bool),
            closed=jnp.zeros((E,), bool),
            gate_start=zi,
            gate_close=zi,
            peak_idx=zi,
            peak_value=jnp.zeros((E,), track.dtype),
            count=jnp.int32(0),
            overflow=jnp.asarray(False),
        )
    idx = jnp.arange(n, dtype=jnp.int32)
    above = above & (idx >= valid_from)

    # Running index of the most recent above sample (-1 if none yet).
    above_idx = jnp.where(above, idx, jnp.int32(-1))
    last_above = blocked.cummax(above_idx)
    below_run = idx - last_above  # 0 at above samples

    # A new gate opens at an above sample if no gate is open: either no
    # previous above exists, or the previous gate already closed (gap > h).
    prev_above = jnp.concatenate([jnp.full((1,), -1, jnp.int32), last_above[:-1]])
    new_cluster = above & ((prev_above < 0) | (idx - prev_above > h))
    cluster_id = blocked.cumsum(new_cluster.astype(jnp.int32))  # 1-based

    # Gate is open from its first above until the h-th consecutive below
    # (that closing sample is still peak-tracked by all reference variants).
    in_gate = (last_above >= 0) & (below_run <= h) & (cluster_id >= 1)

    # Per-gate reductions, unrolled over the (small, static) event capacity.
    # A one-hot masked reduction per slot beats scatter-based segment ops by
    # a wide margin: each slot is a fused compare + reduce sweep,
    # and XLA fuses all slots into few passes over the arrays.
    neg_inf = jnp.full((), -jnp.inf, track.dtype)
    gate_start_l, peak_val_l, peak_idx_l, last_above_l = [], [], [], []
    for c in range(1, max_events + 1):
        m = in_gate & (cluster_id == c)
        gate_start_l.append(jnp.min(jnp.where(m, idx, jnp.int32(_I32_MAX))))
        # single argmax-style selection: deriving the index from
        # `track == max(track)` is UNSOUND under XLA -- the compiler may
        # duplicate the computation of `track` into two fusions with
        # different FMA contraction, making the equality fail bitwise for
        # every element (observed at --xla_backend_optimization_level=0:
        # a gate with a finite peak_value and a sentinel peak_idx)
        masked = jnp.where(m, track, neg_inf)
        if tie == "last":
            pi = jnp.int32(n - 1) - jnp.argmax(masked[::-1]).astype(jnp.int32)
        else:
            pi = jnp.argmax(masked).astype(jnp.int32)
        peak_val_l.append(masked[pi])
        any_m = jnp.any(m)
        if tie == "last":
            peak_idx_l.append(jnp.where(any_m, pi, jnp.int32(-1)))
        else:
            peak_idx_l.append(jnp.where(any_m, pi, jnp.int32(_I32_MAX)))
        last_above_l.append(
            jnp.max(jnp.where(above & (cluster_id == c), idx, jnp.int32(-1)))
        )
    gate_start = jnp.stack(gate_start_l)
    peak_val = jnp.stack(peak_val_l)
    peak_idx = jnp.stack(peak_idx_l)
    last_above_seg = jnp.stack(last_above_l)
    close_raw = last_above_seg + h
    closed = close_raw <= n - 1

    total = cluster_id[-1] if n > 0 else jnp.int32(0)
    c = jnp.arange(max_events, dtype=jnp.int32)
    exists = c < total
    valid = exists & (closed | emit_unclosed)

    gate_close = jnp.clip(close_raw, 0, n - 1)
    count = jnp.sum(valid.astype(jnp.int32))
    # Sanitize fields of non-existent slots so downstream gathers are safe.
    z = jnp.int32(0)
    return GateEvents(
        valid=valid,
        closed=closed & exists,
        gate_start=jnp.where(exists, gate_start, z),
        gate_close=jnp.where(exists, gate_close, z),
        peak_idx=jnp.where(exists, peak_idx, z),
        peak_value=jnp.where(exists, peak_val, jnp.zeros((), track.dtype)),
        count=count,
        overflow=total > max_events,
    )


def merge_stacked_event_tables(
    gathered, *, h: int, E: int, K: int, tie_last: bool, emit_unclosed: bool,
):
    """Merge event tables of consecutive stream pieces, stacked on a leading
    axis in time order, into one table.  `gathered` is (start, close,
    peak_idx, packed_f32(K*E), closed, count, overflow), each
    (n_pieces, B, ...), every piece emitted with global indices and its
    trailing gate open (`emit_unclosed=True`).

    The seam rule is the closed-form cluster rule: a piece's first gate
    continues the previous piece's trailing gate iff the above gap across
    the seam is <= h.  Peak ties are index-aware ('last' -> the larger
    index wins among equal values); the later close wins.  Used for the
    time segments of the GPU kernel and, after an all_gather, for the seq
    shards of `parallel.shard`.  Returns the 8 `GateEvents` fields, then
    K-1 extra packed fields."""
    i32 = jnp.int32
    B = gathered[0].shape[1]
    slot = jnp.arange(E, dtype=i32)[None, :]

    def step(carry, sh):
        (o_start, o_close, o_pidx, o_pval, o_closed, cnt, ovf, trail_la,
         trail_kept) = carry
        s_start, s_close, s_pidx, s_pval, s_closed, s_cnt, s_ovf = sh
        has = s_cnt > 0
        # a continuation merges only into a trailing event the table kept
        # (one dropped for capacity stays dropped, as in the one-shot FSM)
        merge = has & trail_kept & (s_start[:, 0] - trail_la <= h)

        # merge the shard's first piece into the trailing output event.
        # o_pval/s_pval carry K packed f32 fields per slot (peak_value at
        # field 0 decides `take`; extras follow the same selection).
        last_slot = jnp.clip(cnt - 1, 0, E - 1)[:, None]
        sel_last = (slot == last_slot) & merge[:, None]
        fsel_last = jnp.tile(sel_last, (1, K))
        cur_pv = jnp.take_along_axis(o_pval, last_slot, 1)[:, 0]
        cur_pi = jnp.take_along_axis(o_pidx, last_slot, 1)[:, 0]
        new_pv, new_pi = s_pval[:, 0], s_pidx[:, 0]
        if tie_last:
            take = (new_pv > cur_pv) | ((new_pv == cur_pv) & (new_pi > cur_pi))
        else:
            take = (new_pv > cur_pv) | ((new_pv == cur_pv) & (new_pi < cur_pi))
        cur_f = jnp.take_along_axis(
            o_pval, last_slot + E * jnp.arange(K, dtype=i32)[None, :], 1
        )  # (B, K): current packed fields of the trailing event
        new_f = s_pval[
            :, jnp.arange(K, dtype=i32) * E
        ]  # (B, K): the piece's slot-0 packed fields
        mg_f = jnp.where(take[:, None], new_f, cur_f)
        mg_pi = jnp.where(take, new_pi, cur_pi)
        o_pval = jnp.where(
            fsel_last, jnp.repeat(mg_f, E, axis=-1), o_pval
        )
        o_pidx = jnp.where(sel_last, mg_pi[:, None], o_pidx)
        # close: the LATER close wins (a gap-only continuation piece -- a
        # primed gate with no above samples in this shard -- carries an
        # earlier/garbage close and must not regress the trailing event)
        cur_close = jnp.take_along_axis(o_close, last_slot, 1)[:, 0]
        cur_closed = jnp.take_along_axis(o_closed, last_slot, 1)[:, 0]
        adv = s_close[:, 0] >= cur_close
        mg_close = jnp.where(adv, s_close[:, 0], cur_close)
        mg_closed = jnp.where(adv, s_closed[:, 0], cur_closed)
        o_close = jnp.where(sel_last, mg_close[:, None], o_close)
        o_closed = jnp.where(sel_last, mg_closed[:, None], o_closed)
        # (gate_start keeps the earlier piece's value: the trailing output
        #  event opened strictly before the seam)

        # append the remaining pieces in order
        drop = merge.astype(i32)
        koff = jnp.arange(K, dtype=i32)[None, :] * E  # packed-field offsets
        for e in range(E):
            src_ok = (e < s_cnt) & ~(merge & (e == 0))
            dst = cnt + e - drop
            sel = src_ok[:, None] & (slot == dst[:, None])
            fsel = jnp.tile(sel, (1, K))
            o_start = jnp.where(sel, s_start[:, e : e + 1], o_start)
            o_close = jnp.where(sel, s_close[:, e : e + 1], o_close)
            o_pidx = jnp.where(sel, s_pidx[:, e : e + 1], o_pidx)
            o_pval = jnp.where(
                fsel,
                jnp.repeat(jnp.take_along_axis(s_pval, e + koff, 1), E,
                           axis=-1),
                o_pval,
            )
            o_closed = jnp.where(sel, s_closed[:, e : e + 1], o_closed)
        total = cnt + jnp.where(has, s_cnt - drop, 0)
        ovf = ovf | s_ovf | (total > E)
        cnt = jnp.minimum(total, E)
        s_last = jnp.clip(s_cnt - 1, 0, E - 1)[:, None]
        s_trail_close = jnp.take_along_axis(s_close, s_last, 1)[:, 0]
        trail_la = jnp.where(has, s_trail_close - h, trail_la)
        appended = has & (s_cnt - drop > 0)
        trail_kept = jnp.where(appended, total <= E, trail_kept)
        return (o_start, o_close, o_pidx, o_pval, o_closed, cnt, ovf,
                trail_la, trail_kept), None

    z = jnp.zeros((B, E), i32)
    init = (
        z, z, z, jnp.zeros((B, K * E), jnp.float32), jnp.zeros((B, E), bool),
        jnp.zeros((B,), i32), jnp.zeros((B,), bool),
        jnp.full((B,), jnp.iinfo(jnp.int32).min // 2, i32),
        jnp.zeros((B,), bool),
    )
    (o_start, o_close, o_pidx, o_pval, o_closed, cnt, ovf, _, _), _ = (
        jax.lax.scan(step, init, tuple(gathered))
    )
    exists = slot < cnt[:, None]
    valid = exists & (o_closed | emit_unclosed)
    z0 = jnp.int32(0)
    fexists = jnp.tile(exists, (1, K))
    fvals = jnp.where(fexists, o_pval, jnp.float32(0.0))
    out = (
        valid,
        o_closed & exists,
        jnp.where(exists, o_start, z0),
        jnp.where(exists, o_close, z0),
        jnp.where(exists, o_pidx, z0),
        fvals[:, :E],
        jnp.sum(valid.astype(i32), axis=-1),
        ovf,
    )
    extra_out = tuple(fvals[:, k * E : (k + 1) * E] for k in range(1, K))
    return out + extra_out



def gate_open_mask(above: jax.Array, hysteresis: int, valid_from: int = 0) -> jax.Array:
    """Boolean gate-open mask (the `gate_mask` arrays of reference
    minn_rtl.py:817-819, zc_v2.py:382-444)."""
    n = above.shape[-1]
    h = max(int(hysteresis), 1)
    idx = jnp.arange(n, dtype=jnp.int32)
    above = above & (idx >= valid_from)
    last_above = blocked.cummax(jnp.where(above, idx, jnp.int32(-1)))
    return (last_above >= 0) & (idx - last_above <= h)


# ---------------------------------------------------------------------------
# Run-segmentation utilities (plateau / gate-mask post-processing)
# ---------------------------------------------------------------------------

def largest_true_run(mask: jax.Array) -> jax.Array:
    """Keep only the longest contiguous True run (ties -> earliest), as the
    standard-Minn gate cleanup does (reference minn.py:157-181)."""
    n = mask.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    prev = jnp.concatenate([jnp.zeros((1,), mask.dtype), mask[:-1]])
    rising = mask & ~prev
    seg1 = jnp.cumsum(rising.astype(jnp.int32))  # 1-based ids on True samples
    seg = jnp.where(mask, seg1 - 1, n)
    lengths = jax.ops.segment_sum(
        mask.astype(jnp.int32), seg, num_segments=n + 1, indices_are_sorted=True
    )[:n]
    nruns = seg1[-1] if n > 0 else jnp.int32(0)
    lengths = jnp.where(jnp.arange(n) < nruns, lengths, -1)
    best = jnp.argmax(lengths)  # earliest max by argmax convention
    return mask & (seg == best)


def earliest_long_run_end(mask: jax.Array, min_run: int) -> jax.Array:
    """Right edge (last index) of the earliest True run with length >=
    min_run; -1 if none.  Vectorized form of the segment search in the
    Schmidl-Cox plateau picker (reference sc.py:117-133)."""
    n = mask.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    prev = jnp.concatenate([jnp.zeros((1,), mask.dtype), mask[:-1]])
    rising = mask & ~prev
    seg1 = jnp.cumsum(rising.astype(jnp.int32))
    seg = jnp.where(mask, seg1 - 1, n)
    lengths = jax.ops.segment_sum(
        mask.astype(jnp.int32), seg, num_segments=n + 1, indices_are_sorted=True
    )[:n]
    ends = jax.ops.segment_max(
        jnp.where(mask, idx, jnp.int32(-1)), seg, num_segments=n + 1,
        indices_are_sorted=True,
    )[:n]
    nruns = seg1[-1] if n > 0 else jnp.int32(0)
    ok = (jnp.arange(n) < nruns) & (lengths >= min_run)
    first = jnp.argmax(ok)  # earliest qualifying run
    return jnp.where(jnp.any(ok), ends[first], jnp.int32(-1))


def mask_segments(mask) -> list[tuple[int, int]]:
    """Host helper: contiguous [start, end) True segments of a boolean mask
    (reference minn.py:307-319)."""
    import numpy as np

    m = np.asarray(mask).astype(bool)
    if m.size == 0:
        return []
    d = np.diff(m.astype(np.int8))
    starts = list(np.flatnonzero(d == 1) + 1)
    ends = list(np.flatnonzero(d == -1) + 1)
    if m[0]:
        starts = [0] + starts
    if m[-1]:
        ends = ends + [m.size]
    return list(zip(starts, ends))
