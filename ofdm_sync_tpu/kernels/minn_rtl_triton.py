"""Fused Minn-RTL batch detection kernel for the GPU (Pallas, Triton route).

One program owns one stream and one time segment.  It walks its segment in
blocks of exactly Q samples (Q = quarter length), so every delay of the
datapath is a whole number of blocks and lives in loop-carried registers:

  * lag-Q product:   u[n] = sum_c x_c[n] x_c[n-Q]  -- x of the previous block;
  * 2Q corr window:  Wq_j + Wq_{j-1}, Wq_j = (suffix of u_{j-1}) + cumsum(u_j);
  * 3Q energy window: Wp_j + Wp_{j-1} + Wp_{j-2}, the same for p = sum_c x_c^2;
  * smoothing IIR:   s = d^(r+1) s_prev + alpha d^(r-m) cumsum(d^(m-r) c),
    a first-order recurrence solved inside the block with one cumsum
    (weights centred on m = Q/2 keep every term inside float32 range);
  * gate/peak FSM:   the closed form of `ops.detect.extract_gate_events`
    (gates = above-runs with gaps <= h), carried as (last-above index,
    cluster count) plus per-slot (start, last above, peak index, peak value).
    It runs only in blocks that hold an above sample or an open gate.  The
    lag-(h+1) above count it needs is shifted through a per-program scratch
    row in device memory, because Triton has no register shift.

Nothing carries from one program to the next.  Segments after the first read
a halo of NH blocks before their start: three blocks rebuild the window sums,
the rest run the IIR until the missing history has decayed below 2^-45 of the
state, and the last h halo samples prime the gate FSM.  Per-segment tables
(global indices, trailing gates emitted) are stitched by
`ops.detect.merge_stacked_event_tables`, the same seam rule the sharded paths
use across devices.

Input is channel-leading (C, batch, L) float32 or int16, C = 2 * branches
planes [b0_i, b0_q, b1_i, b1_q, ...]; time is the contiguous axis, so a
block load is one coalesced row per plane.  Q must be a power of two >= 16
with in-range IIR weights (`supports`); other configurations take the XLA
path.

Reference parity: ref/minn_antenna_path.sv:33-194,
ref/minn_preamble_detector.sv:247-384, minn_rtl.py:583-825.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ofdm_sync_tpu.ops.detect import GateEvents, merge_stacked_event_tables

_I32_MAX = int(np.iinfo(np.int32).max)
_NEG_INF = float("-inf")
#: programs the segment split aims for: about 4 per SM of a 132-SM card.
#: Measured on an H100 at 512 streams x 2^18 samples: 512 programs of 2
#: warps beat 1024-2048 programs (fewer halo re-reads), and 2 warps beat 1
#: and 4 (PERF.md, kernel tuning)
TARGET_PROGRAMS = 512
NUM_WARPS = 2


def supports(quarter_len: int, hysteresis: int = 1,
             smooth_shift: int = 3) -> bool:
    """The kernel's blocks are Q samples long, Triton blocks are powers of
    two, the gate FSM's lag-(h+1) shift must fit in one block, and the
    in-block IIR weights d^(+-Q/2) must leave float32 room for the metric:
    (1/d)^(Q/2) <= 2^64 (smooth_shift 3 allows Q up to 512)."""
    Q = quarter_len
    if Q < 16 or Q & (Q - 1) or max(int(hysteresis), 1) >= Q:
        return False
    if smooth_shift == 0:
        return True  # no IIR
    d = 1.0 - 1.0 / (1 << smooth_shift)
    return bool((Q // 2) * -np.log2(d) <= 64.0)


def use_kernel(quarter_len: int, smooth_shift: int, hysteresis: int,
               interpret: bool = False) -> bool:
    """The one place that picks the route: the compiled kernel on a GPU,
    the Pallas interpreter only when a test asks for it (`interpret`), and
    the XLA datapath everywhere else (other backends, or a configuration
    the kernel does not support)."""
    if not supports(quarter_len, hysteresis, smooth_shift):
        return False
    return interpret or jax.default_backend() == "gpu"


def scan_memory(smooth_shift: int) -> int:
    """Samples after which the smoothing IIR has forgotten its start state
    to below 2^-45 (sum of the doubling steps a truncated constant-decay
    scan takes; 255 at smooth_shift=3)."""
    decay = 1.0 - (1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0)
    mem, step = 0, 1
    while np.float32(decay**step) > 2.0**-45:
        mem += step
        step *= 2
    return mem


def halo_blocks(quarter_len: int, smooth_shift: int, hysteresis: int) -> int:
    """Q-blocks a segment re-reads before its start: 3 for the window sums,
    then the IIR's memory and the h-sample gate tail."""
    Q = quarter_len
    h = max(int(hysteresis), 1)
    return 3 + -(-(scan_memory(smooth_shift) + 1 + h) // Q)


def segment_len_for(batch: int, stream_len: int, quarter_len: int,
                    n_halo: int) -> int:
    """Segment length (a multiple of Q): enough programs to fill the card
    (`TARGET_PROGRAMS`), while the halo re-read stays under 1/8 of a
    segment."""
    Q = quarter_len
    n_blocks = -(-stream_len // Q)
    max_seg = max(1, n_blocks // (8 * n_halo))
    n_seg = min(max(1, -(-TARGET_PROGRAMS // batch)), max_seg)
    return -(-n_blocks // n_seg) * Q


def _iir_weights(Q: int, smooth_shift: int) -> np.ndarray:
    """(3, Q) float32: d^(r+1), d^(r-m), d^(m-r) with m = Q/2, from float64."""
    alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
    d = 1.0 - alpha
    r = np.arange(Q, dtype=np.float64)
    m = Q // 2
    if d == 0.0:
        return np.zeros((3, Q), np.float32)
    return np.stack([d ** (r + 1), d ** (r - m), d ** (m - r)]).astype(
        np.float32
    )


def _kernel(base_ref, w_ref, x_ref, ev_ref, pv_ref, scr_ref, *, C, Q, E, EP,
            h, H1, NH, nblk, lead, L, Lbuf, alpha, frac, thr, valid_from,
            interpret):
    b = pl.program_id(0)
    j = pl.program_id(1)
    i32, f32 = jnp.int32, jnp.float32
    iota = jnp.arange(Q, dtype=i32)
    slot = jnp.arange(EP, dtype=i32)
    base = plgpu.load(base_ref.at[0])

    seg_pos = lead + j * (nblk * Q)          # buffer position of the segment
    nh = NH if lead else jnp.minimum(j, 1) * NH
    first = seg_pos - nh * Q                 # first buffer position read
    g_seg = base + j * (nblk * Q)            # global index of the segment
    iir_from = jnp.maximum(valid_from, base + (first - lead) + 3 * Q - 1)

    dr1, wpos, wneg = (plgpu.load(w_ref.at[r]) for r in range(3))

    barrier = (lambda: None) if interpret else plgpu.debug_barrier
    plgpu.store(scr_ref.at[b, j, pl.ds(0, H1)], jnp.zeros((H1,), i32))

    def body(k, carry):
        (xprev, au, wq1, ap, wp1, wp2, s_prev, la, cnt,
         st, last, pidx, pval) = carry
        t = seg_pos + k * Q
        gi = base + (t - lead) + iota
        live = (t + iota < Lbuf) & (gi < L)
        xs = tuple(
            plgpu.load(x_ref.at[c, b, pl.ds(t, Q)], mask=live, other=0)
            .astype(f32)
            for c in range(C)
        )
        u = xs[0] * xprev[0]
        p = xs[0] * xs[0]
        for c in range(1, C):
            u = u + xs[c] * xprev[c]
            p = p + xs[c] * xs[c]
        cu = jnp.cumsum(u)
        cp = jnp.cumsum(p)
        wq = au + cu
        wp = ap + cp
        corr_pos = jnp.maximum(wq + wq1, 0.0)
        energy = wp + wp1 + wp2

        valid = gi >= iir_from
        cm = jnp.where(valid, corr_pos, 0.0)
        if alpha == 1.0:
            s = cm
        else:
            s = dr1 * s_prev + f32(alpha) * wpos * jnp.cumsum(wneg * cm)
        s_last = jnp.sum(jnp.where(iota == Q - 1, s, 0.0))

        above = valid & live & (s * f32(1 << frac) >= energy * f32(thr))
        la_blk = jnp.max(jnp.where(above, gi, -1))
        g_t = base + (t - lead)
        open_at = lambda g: (la >= 0) & (la >= g - h)  # noqa: E731
        cnt = jnp.where(k == 0, open_at(g_seg).astype(i32), cnt)
        active = (k >= 0) & ((la_blk >= 0) | open_at(g_t))

        def events(ops):
            cnt, st, last, pidx, pval = ops
            ab = above.astype(i32)
            a_run = jnp.cumsum(ab)
            barrier()
            plgpu.store(scr_ref.at[b, j, pl.ds(H1, Q)], a_run)
            barrier()
            a_lag = plgpu.load(scr_ref.at[b, j, pl.ds(H1 - h - 1, Q)])
            carried = open_at(gi)                   # previous block's tail
            in_gate = ((a_run - a_lag > 0) | carried) & live
            fresh = above & (a_run - ab - a_lag == 0) & ~carried
            cid = cnt + jnp.cumsum(fresh.astype(i32))
            for c in range(1, E + 1):
                m = in_gate & (cid == c)
                bstart = jnp.min(jnp.where(m, gi, _I32_MAX))
                bpv = jnp.max(jnp.where(m, corr_pos, _NEG_INF))
                bidx = jnp.max(jnp.where(m & (corr_pos == bpv), gi, -1))
                blast = jnp.max(jnp.where(above & (cid == c), gi, -1))
                sel = slot == c - 1
                take = (bpv > pval) | ((bpv == pval) & (bpv > _NEG_INF))
                st = jnp.where(sel, jnp.minimum(st, bstart), st)
                last = jnp.where(sel, jnp.maximum(last, blast), last)
                pidx = jnp.where(sel & take, bidx, pidx)
                pval = jnp.where(sel, jnp.maximum(pval, bpv), pval)
            cnt = cnt + jnp.sum(fresh.astype(i32))
            return cnt, st, last, pidx, pval

        cnt, st, last, pidx, pval = jax.lax.cond(
            active, events, lambda ops: ops, (cnt, st, last, pidx, pval)
        )
        return (
            xs, jnp.sum(u) - cu, wq, jnp.sum(p) - cp, wp, wp1, s_last,
            jnp.maximum(la, la_blk), cnt, st, last, pidx, pval,
        )

    zq = jnp.zeros((Q,), f32)
    init = (
        (zq,) * C, zq, zq, zq, zq, zq, f32(0.0), i32(-1), i32(0),
        jnp.full((EP,), _I32_MAX, i32), jnp.full((EP,), -1, i32),
        jnp.full((EP,), -1, i32), jnp.full((EP,), _NEG_INF, f32),
    )
    out = jax.lax.fori_loop(-nh, nblk, body, init)
    cnt, st, last, pidx, pval = out[8:]
    plgpu.store(ev_ref.at[b, j, 0], st)
    plgpu.store(ev_ref.at[b, j, 1], last)
    plgpu.store(ev_ref.at[b, j, 2], pidx)
    plgpu.store(ev_ref.at[b, j, 3], jnp.full((EP,), cnt, i32))
    plgpu.store(pv_ref.at[b, j], pval)


@functools.partial(
    jax.jit,
    static_argnames=(
        "quarter_len", "smooth_shift", "threshold_value",
        "threshold_frac_bits", "hysteresis", "max_events", "emit_unclosed",
        "stream_len", "lead", "segment_len", "interpret",
    ),
)
def minn_rtl_detect_triton(
    x: jax.Array,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    max_events: int = 8,
    emit_unclosed: bool = False,
    stream_len: int | None = None,
    lead: int = 0,
    base: jax.Array | int = 0,
    segment_len: int | None = None,
    interpret: bool = False,
) -> GateEvents:
    """Minn-RTL gate/peak event tables for a batch of streams.

    x: (C, batch, Lbuf) float32 or int16, channel-leading.  Returns
    `GateEvents` with (batch, max_events) fields, equal to
    `kernels.streaming.minn_rtl_detect_planar` run per stream
    (tie='last', the RTL's `>=` peak update).

    Sharded use: the first `lead` buffer samples are a halo from the left
    neighbour (`lead` is 0 or `halo_blocks(...) * Q`); `base` (int32
    scalar, may be traced) is the global index of buffer position `lead`;
    `stream_len` is the GLOBAL stream length (samples at or past it are
    masked).  Emitted indices are global.  `interpret=True` runs the Pallas
    interpreter (CPU tests); otherwise the kernel compiles for the GPU.
    """
    Q = quarter_len
    if not supports(Q, hysteresis, smooth_shift):
        raise ValueError(
            f"quarter_len={Q} must be a power of two >= 16 above the "
            f"hysteresis {hysteresis}, with in-range IIR weights at "
            f"smooth_shift {smooth_shift} (`supports`)"
        )
    C, batch, Lbuf = x.shape
    h = max(int(hysteresis), 1)
    NH = halo_blocks(Q, smooth_shift, hysteresis)
    if lead not in (0, NH * Q):
        raise ValueError(f"lead must be 0 or {NH * Q}, got {lead}")
    own = Lbuf - lead
    L = own if stream_len is None else stream_len
    seg = segment_len or segment_len_for(batch, own, Q, NH)
    if seg % Q or (seg < NH * Q and seg < own):
        raise ValueError(f"segment_len {seg} must be a multiple of {Q} "
                         f"and at least the {NH * Q}-sample halo")
    n_seg = -(-own // seg)
    E = max_events
    EP = 1 << max(E - 1, 1).bit_length()        # Triton wants powers of two
    H1 = 1 << max(h, 15).bit_length()            # scratch lead >= h + 1
    alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0

    kernel = functools.partial(
        _kernel, C=C, Q=Q, E=E, EP=EP, h=h, H1=H1, NH=NH, nblk=seg // Q,
        lead=lead, L=L, Lbuf=Lbuf, alpha=alpha, frac=threshold_frac_bits,
        thr=threshold_value, valid_from=3 * Q - 1, interpret=interpret,
    )
    ev, pv, _ = pl.pallas_call(
        kernel,
        grid=(batch, n_seg),
        out_shape=[
            jax.ShapeDtypeStruct((batch, n_seg, 4, EP), jnp.int32),
            jax.ShapeDtypeStruct((batch, n_seg, EP), jnp.float32),
            jax.ShapeDtypeStruct((batch, n_seg, H1 + Q), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="minn_rtl_detect",
    )(
        jnp.asarray(base, jnp.int32).reshape(1),
        jnp.asarray(_iir_weights(Q, smooth_shift)),
        x,
    )
    return _segment_tables_to_events(
        ev[..., :E], pv[..., :E], h=h, L=L, E=E, emit_unclosed=emit_unclosed
    )


def _segment_tables_to_events(ev, pv, *, h, L, E, emit_unclosed):
    """(batch, n_seg, 4, E) raw per-segment slots -> one merged table."""
    start, last, pidx, cnt = ev[:, :, 0], ev[:, :, 1], ev[:, :, 2], ev[:, :, 3, 0]
    slot = jnp.arange(E, dtype=jnp.int32)
    exists = slot < jnp.minimum(cnt, E)[..., None]
    close_raw = last + h
    z = jnp.int32(0)
    pieces = (
        jnp.where(exists, start, z),
        jnp.where(exists, jnp.clip(close_raw, 0, L - 1), z),
        jnp.where(exists, pidx, z),
        jnp.where(exists, pv, jnp.float32(0.0)),
        (close_raw <= L - 1) & exists,
        jnp.sum(exists.astype(jnp.int32), axis=-1),
        cnt > E,
    )
    pieces = tuple(jnp.moveaxis(a, 1, 0) for a in pieces)  # (n_seg, batch..)
    out = merge_stacked_event_tables(
        pieces, h=h, E=E, K=1, tie_last=True, emit_unclosed=emit_unclosed
    )
    return GateEvents(*out[:8])


def minn_rtl_detect_xla(
    x: jax.Array,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    max_events: int = 8,
) -> GateEvents:
    """Plain reference for `minn_rtl_detect_triton`: the XLA datapath
    (`minn_rtl_metric_planar` + `extract_gate_events`) per stream over the
    same channel-leading (C, batch, L) input."""
    from ofdm_sync_tpu.kernels.streaming import minn_rtl_detect_planar

    def one(stream):
        _, table = minn_rtl_detect_planar(
            stream.astype(jnp.float32).reshape(stream.shape[0] // 2, 2, -1),
            quarter_len=quarter_len, smooth_shift=smooth_shift,
            threshold_value=threshold_value,
            threshold_frac_bits=threshold_frac_bits,
            hysteresis=hysteresis, max_events=max_events,
        )
        return table

    return jax.vmap(one, in_axes=1)(x)


def minn_rtl_detect(x: jax.Array, *, interpret: bool = False,
                    **kw) -> GateEvents:
    """Minn-RTL event tables of a channel-leading (C, batch, L) batch on
    the route `use_kernel` picks: `minn_rtl_detect_triton` or
    `minn_rtl_detect_xla` (same tables; keywords as theirs)."""
    if use_kernel(kw["quarter_len"], kw["smooth_shift"], kw["hysteresis"],
                  interpret):
        return minn_rtl_detect_triton(x, **kw, interpret=interpret)
    return minn_rtl_detect_xla(x, **kw)


def halo_len(quarter_len: int, smooth_shift: int, hysteresis: int) -> int:
    """Samples of left halo a sharded caller passes as `lead`."""
    return halo_blocks(quarter_len, smooth_shift, hysteresis) * quarter_len


__all__ = [
    "TARGET_PROGRAMS", "halo_blocks", "halo_len", "minn_rtl_detect",
    "minn_rtl_detect_triton", "minn_rtl_detect_xla", "scan_memory",
    "segment_len_for", "supports", "use_kernel",
]
