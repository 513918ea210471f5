"""Multi-chip sharding: mesh construction, halo exchange, blocked scans.

The reference is single-process NumPy (SURVEY section 2.5); this module is
the scaling layer it lacks.  Two parallel axes map to the math:

  * ``data``: independent streams / sweep configs -- embarrassingly parallel
    (the reference's serial grid loops, reference sync_aa.py:829-899).
  * ``seq``: the IQ time axis -- sequence parallelism via overlap-save.
    Every detector metric is a function of a bounded window, so each shard
    needs only a halo of neighbor samples (one ``ppermute``) to compute
    its metric chunk EXACTLY; the only unbounded-history op is the RTL
    smoothing IIR, handled with an exact blocked linear-recurrence scan
    (per-shard scan + one tiny cross-shard carry fix-up).

Everything here is exact: sharded output == single-device output bit-for-bit
(up to float associativity in the IIR carry, covered by tests).
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ofdm_sync_tpu.ops.detect import merge_stacked_event_tables


def make_stream_mesh(
    n_data: int = 1, n_seq: int | None = None, devices=None
) -> Mesh:
    """Mesh with axes (data, seq).  Defaults to all devices on the seq axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_seq is None:
        n_seq = devices.size // n_data
    if n_data * n_seq != devices.size:
        raise ValueError(f"{n_data}x{n_seq} != {devices.size} devices")
    return Mesh(devices.reshape(n_data, n_seq), axis_names=("data", "seq"))


# ---------------------------------------------------------------------------
# Halo exchange (inside shard_map)
# ---------------------------------------------------------------------------

def halo_exchange(block: jax.Array, left: int, right: int, axis_name: str) -> jax.Array:
    """Extend a per-shard block with `left` trailing samples from the left
    neighbor and `right` leading samples from the right neighbor.

    Boundary shards get ZEROS -- matching the zero-filled delay-line priming
    of the RTL streaming model (reference ref/minn_delay_line.sv:58-74), so a
    causal metric on the extended block reproduces the unsharded stream
    exactly.  Call INSIDE shard_map.  Works on the last axis.
    """
    idx = jax.lax.axis_index(axis_name)
    n_shards = jax.lax.axis_size(axis_name)
    parts = []
    if left > 0:
        tail = block[..., -left:]
        # send my tail to my RIGHT neighbor == receive from LEFT neighbor
        from_left = jax.lax.ppermute(
            tail, axis_name, [(i, i + 1) for i in range(n_shards - 1)]
        )
        from_left = jnp.where(idx > 0, from_left, jnp.zeros_like(from_left))
        parts.append(from_left)
    parts.append(block)
    if right > 0:
        head = block[..., :right]
        from_right = jax.lax.ppermute(
            head, axis_name, [(i + 1, i) for i in range(n_shards - 1)]
        )
        from_right = jnp.where(
            idx < n_shards - 1, from_right, jnp.zeros_like(from_right)
        )
        parts.append(from_right)
    return jnp.concatenate(parts, axis=-1)


# ---------------------------------------------------------------------------
# Blocked linear recurrence (exact cross-shard IIR)
# ---------------------------------------------------------------------------

def blocked_linear_recurrence(a: jax.Array, b: jax.Array, axis_name: str) -> jax.Array:
    """Exact ``s[n] = a[n] s[n-1] + b[n]`` across shards of the last axis.

    Per-shard associative scan from zero, then a carry fix-up:
    ``s = s_local + s_carry_in * cumprod(a)`` where the incoming carry is the
    exclusive prefix-combination of per-shard (prod a, final s).  The carry
    combine is a tiny all-gather of 2 scalars per shard.
    Call INSIDE shard_map.
    """
    from ofdm_sync_tpu.ops.windows import linear_recurrence

    s_local = linear_recurrence(a, b)
    cum_a = jnp.cumprod(a, axis=-1)
    A_tot = cum_a[..., -1]
    S_tot = s_local[..., -1]

    n_shards = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    A_all = jax.lax.all_gather(A_tot, axis_name)  # (n_shards, ...)
    S_all = jax.lax.all_gather(S_tot, axis_name)

    # exclusive scan over shards: carry into shard k is
    # sum_{j<k} S_all[j] * prod_{j<m<k} A_all[m]
    def step(carry, js):
        A_j, S_j = js
        return carry * A_j + S_j, carry

    _, carries = jax.lax.scan(step, jnp.zeros_like(S_tot), (A_all, S_all))
    my_carry = carries[idx]
    return s_local + my_carry[..., None] * cum_a


# ---------------------------------------------------------------------------
# Sharded detector metrics
# ---------------------------------------------------------------------------

def sharded_minn_rtl_metric(
    rx: jax.Array,
    mesh: Mesh,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
):
    """Minn-RTL metric with the time axis sharded over mesh axis 'seq' and
    branches/batch replicated.  Exact vs the single-device
    `ops.metrics.minn_rtl_metric` (tests assert equality).

    rx: (branches, L) with L divisible by the seq axis size.

    Implementation: each shard computes its quarter-product locally after a
    left halo of 3Q+... samples (enough history for the Q-window running sums
    and the Q/2Q delay taps), then the smoothing IIR runs as a blocked scan.
    """
    Q = quarter_len
    history = 3 * Q  # delay Q + running-sum window Q + 2Q tap shift
    n = rx.shape[-1]
    n_seq = mesh.shape["seq"]
    if n % n_seq:
        raise ValueError(f"stream length {n} not divisible by seq={n_seq}")
    block = n // n_seq
    alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
    valid_from = max(0, 3 * Q - 1)

    def shard_fn(x_blk):
        # x_blk: (branches, block)
        ext = halo_exchange(x_blk, history, 0, "seq")
        xd = jnp.concatenate(
            [jnp.zeros_like(ext[..., :Q]), ext[..., :-Q]], axis=-1
        )
        # mask the zero-fill at the true stream start (global index < Q)
        start = jax.lax.axis_index("seq") * block - history
        gidx = start + jnp.arange(ext.shape[-1])
        qp = (ext * jnp.conj(xd)).real
        qp = jnp.where(gidx >= 0, qp, 0.0)  # positions before stream start
        power = jnp.where(gidx >= 0, jnp.abs(ext) ** 2, 0.0)

        cs_q = jnp.cumsum(qp, axis=-1)
        cs_p = jnp.cumsum(power, axis=-1)

        def win(cs):
            return cs - jnp.concatenate(
                [jnp.zeros_like(cs[..., :Q]), cs[..., :-Q]], axis=-1
            )

        corr = win(cs_q)
        energy = win(cs_p)
        # NOTE: running sums computed from halo'd cumsum are exact only for
        # positions >= history into the extended block; the halo is sized so
        # every position of the true block qualifies (or is masked warm-up).
        def tap(xa, d):
            return jnp.concatenate(
                [jnp.zeros_like(xa[..., :d]), xa[..., :-d]], axis=-1
            )

        corr_total = corr + tap(corr, Q)
        energy_total = energy + tap(energy, Q) + tap(energy, 2 * Q)
        # crop halo, sum branches
        corr_total = jnp.sum(corr_total[..., history:], axis=0)
        energy_total = jnp.sum(energy_total[..., history:], axis=0)

        gi = jax.lax.axis_index("seq") * block + jnp.arange(block)
        metric_valid = gi >= valid_from
        corr_positive = jnp.maximum(corr_total, 0.0)

        a = jnp.where(metric_valid, 1.0 - alpha, 1.0).astype(corr_positive.dtype)
        b = jnp.where(metric_valid, alpha * corr_positive, 0.0)
        smooth = blocked_linear_recurrence(a, b, "seq")

        corr_scaled = smooth * (1 << threshold_frac_bits)
        energy_scaled = energy_total * float(threshold_value)
        above = metric_valid & (corr_scaled >= energy_scaled)
        return corr_positive, smooth, energy_total, above

    spec = P(None, "seq")
    out_spec = P("seq")
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=(out_spec, out_spec, out_spec, out_spec),
        check_vma=False,
    )
    return fn(rx)


def sharded_aa_metric(rx: jax.Array, mesh: Mesh, L: int):
    """[A][A] streaming metric sharded over 'seq'.  Exact vs
    `ops.metrics.aa_metric` (history = 2L: delay L + running window L)."""
    history = 2 * L
    n = rx.shape[-1]
    n_seq = mesh.shape["seq"]
    if n % n_seq:
        raise ValueError(f"stream length {n} not divisible by seq={n_seq}")
    block = n // n_seq

    def shard_fn(x_blk):
        ext = halo_exchange(x_blk, history, 0, "seq")
        start = jax.lax.axis_index("seq") * block - history
        gidx = start + jnp.arange(ext.shape[-1])
        xd = jnp.concatenate([jnp.zeros_like(ext[..., :L]), ext[..., :-L]], axis=-1)
        prod = ext * jnp.conj(xd)
        prod = jnp.where(gidx >= L, prod, jnp.zeros((), prod.dtype))
        power = jnp.where(gidx >= 0, jnp.abs(ext) ** 2, 0.0)

        def win(x):
            cs = jnp.cumsum(x, axis=-1)
            return cs - jnp.concatenate(
                [jnp.zeros_like(cs[..., :L]), cs[..., :-L]], axis=-1
            )

        Pc = jnp.sum(win(prod)[..., history:], axis=0)
        R = jnp.sum(win(power)[..., history:], axis=0)
        gi = jax.lax.axis_index("seq") * block + jnp.arange(block)
        valid = gi >= L
        noise_floor = 1e-6 * L
        M = jnp.where(
            valid & (R > noise_floor),
            jnp.minimum(jnp.abs(Pc) ** 2 / jnp.maximum(R, 1e-12) ** 2, 1.0),
            0.0,
        )
        return Pc, R, M, valid

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, "seq"),),
        out_specs=(P("seq"), P("seq"), P("seq"), P("seq")),
        check_vma=False,
    )
    return fn(rx)


def sharded_sc_metric(rx: jax.Array, mesh: Mesh, n_fft: int):
    """Schmidl-Cox metric sharded over 'seq'.

    Forward-looking window: each shard needs a RIGHT halo of N-1 samples.
    Output is the full out_len = L - N + 1 array, computed shard-locally and
    cropped (the final shard's tail beyond out_len is dropped by the caller).
    Returns (M, P, R) each of global length L (last N-1 entries undefined,
    caller slices [:L - n_fft + 1])."""
    half = n_fft // 2
    n = rx.shape[-1]
    n_seq = mesh.shape["seq"]
    if n % n_seq:
        raise ValueError(f"stream length {n} not divisible by seq={n_seq}")
    block = n // n_seq
    halo = n_fft  # need samples d .. d+N-1 for offset d

    def shard_fn(x_blk):
        ext = halo_exchange(x_blk, 0, halo, "seq")
        u = ext[..., :-half] * jnp.conj(ext[..., half:])
        csu = jnp.cumsum(u, axis=-1)
        Pw = jnp.concatenate(
            [csu[..., half - 1 : half], csu[..., half:] - csu[..., :-half]], axis=-1
        )
        p = jnp.abs(ext) ** 2
        csp = jnp.cumsum(p, axis=-1)
        S = jnp.concatenate(
            [csp[..., half - 1 : half], csp[..., half:] - csp[..., :-half]], axis=-1
        )
        Pc = jnp.sum(Pw[..., :block], axis=0)
        R = jnp.sum(S[..., half : half + block], axis=0)
        M = (jnp.abs(Pc) ** 2) / jnp.maximum(R, 1e-12) ** 2
        return M, Pc, R

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, "seq"),),
        out_specs=(P("seq"), P("seq"), P("seq")),
        check_vma=False,
    )
    return fn(rx)


def sharded_minn_rtl_planar(
    iq: jax.Array,
    mesh: Mesh,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
):
    """Full dp x sp sharded Minn-RTL metric on planar-float IQ.

    iq: (batch, branches, 2, L) float32 with batch sharded over mesh axis
    'data' and L over 'seq'.  The flagship multi-chip step: data parallelism
    over streams, sequence parallelism over time with halo exchange + blocked
    IIR scan.  Returns (corr_positive, smooth, energy_total, above),
    each (batch, L) sharded P('data', 'seq').
    """
    Q = quarter_len
    history = 3 * Q
    n = iq.shape[-1]
    n_seq = mesh.shape["seq"]
    n_data = mesh.shape["data"]
    if n % n_seq or iq.shape[0] % n_data:
        raise ValueError("batch/stream dims not divisible by mesh axes")
    block = n // n_seq
    alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
    valid_from = max(0, 3 * Q - 1)

    def shard_fn(blk):
        # blk: (B_loc, branches, 2, block)
        ext = halo_exchange(blk, history, 0, "seq")
        i, q = ext[..., 0, :], ext[..., 1, :]
        zQ = jnp.zeros_like(i[..., :Q])

        def tap(x, d):
            z = jnp.zeros_like(x[..., :d])
            return jnp.concatenate([z, x[..., :-d]], axis=-1)

        qp = i * tap(i, Q) + q * tap(q, Q)
        power = i * i + q * q

        def win(x):
            cs = jnp.cumsum(x, axis=-1)
            return cs - jnp.concatenate(
                [jnp.zeros_like(cs[..., :Q]), cs[..., :-Q]], axis=-1
            )

        corr = win(qp)
        energy = win(power)
        corr_total = jnp.sum(corr + tap(corr, Q), axis=-2)[..., history:]
        energy_total = jnp.sum(
            energy + tap(energy, Q) + tap(energy, 2 * Q), axis=-2
        )[..., history:]
        corr_positive = jnp.maximum(corr_total, 0.0)

        gi = jax.lax.axis_index("seq") * block + jnp.arange(block)
        metric_valid = gi >= valid_from
        a = jnp.where(metric_valid, 1.0 - alpha, 1.0).astype(corr_positive.dtype)
        a = jnp.broadcast_to(a, corr_positive.shape)
        b = jnp.where(metric_valid, alpha * corr_positive, 0.0)
        smooth = blocked_linear_recurrence(a, b, "seq")

        above = metric_valid & (
            smooth * (1 << threshold_frac_bits)
            >= energy_total * float(threshold_value)
        )
        return corr_positive, smooth, energy_total, above

    spec_in = P("data", None, None, "seq")
    spec_out = P("data", "seq")
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec_in,),
        out_specs=(spec_out, spec_out, spec_out, spec_out),
        check_vma=False,
    )
    return fn(iq)


def _cross_shard_event_merge(
    above: jax.Array,
    track: jax.Array,
    gi_b: jax.Array,
    *,
    h: int,
    E: int,
    n: int,
    tie_last: bool,
    emit_unclosed: bool,
    axis_name: str = "seq",
    extras: tuple = (),
):
    """Closed-form gate/peak event extraction with the cluster state merged
    across `axis_name` shards (call INSIDE shard_map).

    above/track/gi_b: (..., block) per-shard boolean gate input, peak-tracked
    value, and global sample indices.  Returns the 8 GateEvents fields
    (valid, closed, gate_start, gate_close, peak_idx, peak_value, count,
    overflow), replicated over the shard axis; with `extras` (per-sample
    arrays to capture at the winning peak, e.g. P for CFO, reference
    sync_aa.py:533), a tuple of (..., E) captured values is appended.

    Same closed form as the fused kernels (gates = above-clusters with gaps
    <= h, reference minn_rtl.py:750-825): the only cross-shard state is
    (last-above index, #clusters), combined with exclusive scans over
    all-gathered per-shard summaries; per-slot reductions combine with
    pmin/pmax.  Peak ties resolve globally ('last' -> highest index
    among value ties, as the RTL's >= update).
    """
    I32_MAX = jnp.iinfo(jnp.int32).max
    NEG_INF = jnp.float32(-jnp.inf)
    sidx = jax.lax.axis_index(axis_name)

    above_idx = jnp.where(above, gi_b, jnp.int32(-1))
    la_local = jax.lax.cummax(above_idx, axis=above_idx.ndim - 1)
    la_final = la_local[..., -1]
    la_all = jax.lax.all_gather(la_final, axis_name)  # (n_seq, B_loc)
    la_run = jax.lax.associative_scan(jnp.maximum, la_all, axis=0)
    carry_la = jnp.where(
        sidx > 0,
        la_run[jnp.maximum(sidx - 1, 0)],
        jnp.full_like(la_final, -1),
    )[..., None]
    last_above = jnp.maximum(la_local, carry_la)
    prev_above = jnp.maximum(
        jnp.concatenate(
            [jnp.full_like(la_local[..., :1], -1), la_local[..., :-1]],
            axis=-1,
        ),
        carry_la,
    )
    new_cluster = above & ((prev_above < 0) | (gi_b - prev_above > h))
    counts = jnp.sum(new_cluster.astype(jnp.int32), axis=-1)
    counts_all = jax.lax.all_gather(counts, axis_name)
    counts_run = jnp.cumsum(counts_all, axis=0)
    carry_count = jnp.where(
        sidx > 0,
        counts_run[jnp.maximum(sidx - 1, 0)],
        jnp.zeros_like(counts),
    )[..., None]
    cluster_id = carry_count + jnp.cumsum(
        new_cluster.astype(jnp.int32), axis=-1
    )
    in_gate = (last_above >= 0) & (gi_b - last_above <= h) & (cluster_id >= 1)

    total = carry_count[..., 0] + counts  # identical on last shard
    total = jax.lax.pmax(total, axis_name)

    # Per-slot local reductions are stacked to (..., E) so each quantity
    # needs ONE batched collective over the shard axis, not E tiny
    # latency-bound ones (3 rounds: extents/values -> peak index -> extras).
    ms, starts, lasts, lpvs, lidx_local = [], [], [], [], []
    for c in range(1, E + 1):
        m = in_gate & (cluster_id == c)
        ms.append(m)
        starts.append(
            jnp.min(jnp.where(m, gi_b, jnp.int32(I32_MAX)), axis=-1)
        )
        lasts.append(
            jnp.max(
                jnp.where(above & (cluster_id == c), gi_b, jnp.int32(-1)),
                axis=-1,
            )
        )
        # per-slot local (value, index) via ONE argmax-based selection:
        # `track == max(track)` is unsound under XLA (the compiler may
        # duplicate `track` into fusions with different FMA contraction,
        # failing the bitwise equality -- see ops/detect.py); the gathered
        # value is the single source of truth for the cross-shard compare
        masked = jnp.where(m, track, NEG_INF)
        nloc = masked.shape[-1]
        if tie_last:
            ji = jnp.int32(nloc - 1) - jnp.argmax(
                masked[..., ::-1], axis=-1
            ).astype(jnp.int32)
        else:
            ji = jnp.argmax(masked, axis=-1).astype(jnp.int32)
        pv = jnp.take_along_axis(masked, ji[..., None], axis=-1)[..., 0]
        gidx = jnp.take_along_axis(
            jnp.broadcast_to(gi_b, masked.shape), ji[..., None], axis=-1
        )[..., 0].astype(jnp.int32)
        lpvs.append(pv)
        lidx_local.append((jnp.any(m, axis=-1), gidx))
    gate_start = jax.lax.pmin(jnp.stack(starts, axis=-1), axis_name)
    last_seg = jax.lax.pmax(jnp.stack(lasts, axis=-1), axis_name)
    lpv = jnp.stack(lpvs, axis=-1)
    peak_val = jax.lax.pmax(lpv, axis_name)

    # the winning shard identifies itself by comparing its MATERIALIZED
    # local best against the collective max (values cross the collective
    # verbatim, so this equality is exact)
    lidxs = []
    for c in range(1, E + 1):
        any_m, gidx = lidx_local[c - 1]
        winner = any_m & (lpv[..., c - 1] == peak_val[..., c - 1])
        if tie_last:
            lidxs.append(jnp.where(winner, gidx, jnp.int32(-1)))
        else:
            lidxs.append(jnp.where(winner, gidx, jnp.int32(I32_MAX)))
    stacked = jnp.stack(lidxs, axis=-1)
    if tie_last:
        peak_idx = jax.lax.pmax(stacked, axis_name)
    else:
        peak_idx = jax.lax.pmin(stacked, axis_name)

    # capture side channels at the winning peak (gi unique globally:
    # exactly one shard contributes, one psum per extra collects all slots)
    extra_vals = []
    for arr in extras:
        cols = [
            jnp.sum(
                jnp.where(
                    ms[c - 1] & (gi_b == peak_idx[..., c - 1 : c]),
                    arr,
                    jnp.zeros_like(arr),
                ),
                axis=-1,
            )
            for c in range(1, E + 1)
        ]
        extra_vals.append(
            jax.lax.psum(jnp.stack(cols, axis=-1), axis_name)
        )

    slots = jnp.arange(E, dtype=jnp.int32)
    exists = slots[None, :] < jnp.minimum(total, E)[..., None]
    close_raw = last_seg + h
    closed = (close_raw <= n - 1) & exists
    valid = exists if emit_unclosed else (exists & closed)
    z = jnp.int32(0)
    return (
        valid,
        closed,
        jnp.where(exists, gate_start, z),
        jnp.where(exists, jnp.clip(close_raw, 0, n - 1), z),
        jnp.where(exists, peak_idx, z),
        jnp.where(exists, peak_val, jnp.float32(0.0)),
        jnp.sum(valid.astype(jnp.int32), axis=-1),
        total > E,
    ) + tuple(
        jnp.where(exists, v, jnp.zeros_like(v)) for v in extra_vals
    )


def sharded_minn_rtl_detect(
    iq: jax.Array,
    mesh: Mesh,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    max_events: int = 8,
    tie: str = "last",
    emit_unclosed: bool = False,
):
    """Fully-sharded detection: dp x sp metric AND cross-shard event merge.

    iq: (batch, branches, 2, L) float32, batch over 'data', L over 'seq'.
    Returns a GateEvents table with batch sharded over 'data' and the event
    fields REPLICATED over 'seq' -- identical to running
    `extract_gate_events` on the unsharded stream (tests assert equality).

    Event merging across seq shards uses the same closed form as the fused
    kernels (gates = above-clusters with gaps <= h): the only cross-shard
    state is (last-above index, #clusters), combined with exclusive scans
    over all-gathered per-shard summaries; per-slot reductions then combine
    with pmin/pmax.  Peak ties resolve globally ('last' -> highest
    index among value ties, as the RTL's >= update).
    """
    from ofdm_sync_tpu.ops.detect import GateEvents

    Q = quarter_len
    history = 3 * Q
    n = iq.shape[-1]
    n_seq = mesh.shape["seq"]
    n_data = mesh.shape["data"]
    if n % n_seq or iq.shape[0] % n_data:
        raise ValueError("batch/stream dims not divisible by mesh axes")
    block = n // n_seq
    alpha = 1.0 / (1 << smooth_shift) if smooth_shift > 0 else 1.0
    valid_from = max(0, 3 * Q - 1)
    h = max(int(hysteresis), 1)
    E = max_events
    tie_last = tie == "last"

    def shard_fn(blk):
        # ---- metric (identical math to sharded_minn_rtl_planar) ----
        ext = halo_exchange(blk, history, 0, "seq")
        i, q = ext[..., 0, :], ext[..., 1, :]

        def tap(x, d):
            z = jnp.zeros_like(x[..., :d])
            return jnp.concatenate([z, x[..., :-d]], axis=-1)

        qp = i * tap(i, Q) + q * tap(q, Q)
        power = i * i + q * q

        def win(x, W):
            cs = jnp.cumsum(x, axis=-1)
            return cs - jnp.concatenate(
                [jnp.zeros_like(cs[..., :W]), cs[..., :-W]], axis=-1
            )

        corr_total = jnp.sum(win(qp, 2 * Q), axis=-2)[..., history:]
        energy_total = jnp.sum(win(power, 3 * Q), axis=-2)[..., history:]
        corr_pos = jnp.maximum(corr_total, 0.0)

        sidx = jax.lax.axis_index("seq")
        gi = sidx * block + jnp.arange(block, dtype=jnp.int32)
        metric_valid = gi >= valid_from
        a = jnp.where(metric_valid, 1.0 - alpha, 1.0).astype(corr_pos.dtype)
        a = jnp.broadcast_to(a, corr_pos.shape)
        b = jnp.where(metric_valid, alpha * corr_pos, 0.0)
        smooth = blocked_linear_recurrence(a, b, "seq")
        above = metric_valid & (
            smooth * (1 << threshold_frac_bits)
            >= energy_total * float(threshold_value)
        )

        # ---- cross-shard event merge ----
        gi_b = jnp.broadcast_to(gi, above.shape)
        return _cross_shard_event_merge(
            above, corr_pos, gi_b, h=h, E=E, n=n,
            tie_last=tie_last, emit_unclosed=emit_unclosed,
        )

    spec_in = P("data", None, None, "seq")
    rep = P("data")  # replicated over seq
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec_in,),
        out_specs=(rep, rep, rep, rep, rep, rep, rep, rep),
        check_vma=False,
    )
    valid, closed, gs, gc, pi, pv, count, overflow = fn(iq)
    return GateEvents(
        valid=valid, closed=closed, gate_start=gs, gate_close=gc,
        peak_idx=pi, peak_value=pv, count=count, overflow=overflow,
    )


def sharded_minn_rtl_detect_fused(
    iq: jax.Array,
    mesh: Mesh,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    max_events: int = 8,
    emit_unclosed: bool = False,
    interpret: bool = False,
):
    """Multi-device Minn-RTL detection on the fused GPU kernel
    (`kernels.minn_rtl_triton`) + a table-level collective event merge.

    iq: (2*branches, batch, L) channel-leading planar IQ, float32 or int16,
    batch over 'data', L over 'seq'.  Per shard, ONE ppermute brings the
    W = `minn_rtl_triton.halo_len` samples before the shard from the left
    neighbour (zeros at shard 0; int16 stays int16 on the wire).  The
    kernel reads them as its `lead`: 3Q samples rebuild the window sums,
    the rest run the smoothing IIR until the missing history has decayed
    below 2^-45 of its state, and the last h prime the gate FSM -- the same
    algebra the kernel uses between its own time segments.  The kernel
    emits per-shard tables with global indices and trailing gates open;
    `_merge_shard_event_tables` stitches seam-spanning gates (gap <= h
    rule, index-aware peak ties, later close wins) from one all_gather of
    the tables -- a few hundred bytes per shard.  Returns GateEvents with
    batch over 'data', replicated over 'seq', equal to the unsharded
    detection (tests place gates on shard boundaries).

    The kernel needs a GPU; `interpret=True` runs it in the Pallas
    interpreter (tests on a CPU mesh).  `sharded_minn_rtl_detect` is the
    XLA form for other backends.
    """
    from ofdm_sync_tpu.kernels import minn_rtl_triton as mt
    from ofdm_sync_tpu.ops.detect import GateEvents

    Q = quarter_len
    n = iq.shape[-1]
    n_seq = mesh.shape["seq"]
    n_data = mesh.shape["data"]
    if n % n_seq or iq.shape[1] % n_data:
        raise ValueError("batch/stream dims not divisible by mesh axes")
    if not mt.use_kernel(Q, smooth_shift, hysteresis, interpret):
        raise ValueError(
            "the fused kernel runs on a GPU (or with interpret=True) for a "
            "configuration `minn_rtl_triton.supports`; use "
            "sharded_minn_rtl_detect otherwise"
        )
    block = n // n_seq
    h = max(int(hysteresis), 1)
    W = mt.halo_len(Q, smooth_shift, hysteresis)
    if block < W:
        raise ValueError(
            f"seq shard of {block} samples is shorter than the W={W} halo "
            f"(3Q window reach + smoothing runway at smooth_shift="
            f"{smooth_shift} + hysteresis={h}); use fewer seq shards"
        )

    def shard_fn(blk):
        # blk: (C, B_loc, block)
        sidx = jax.lax.axis_index("seq")
        from_left = jax.lax.ppermute(
            blk[..., -W:], "seq", [(i, i + 1) for i in range(n_seq - 1)]
        )
        halo = jnp.where(sidx > 0, from_left, jnp.zeros_like(from_left))
        table = mt.minn_rtl_detect_triton(
            jnp.concatenate([halo, blk], axis=-1),
            quarter_len=Q,
            smooth_shift=smooth_shift,
            threshold_value=threshold_value,
            threshold_frac_bits=threshold_frac_bits,
            hysteresis=hysteresis,
            max_events=max_events,
            emit_unclosed=True,  # boundary gates must surface for merging
            stream_len=n,
            lead=W,
            base=sidx * block,
            interpret=interpret,
        )
        return _merge_shard_event_tables(
            table, axis_name="seq", h=h, E=max_events, tie_last=True,
            emit_unclosed=emit_unclosed,
        )

    rep = P("data")
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, "data", "seq"),),
        out_specs=(rep,) * 8,
        check_vma=False,
    )
    return GateEvents(*fn(iq))


def _merge_shard_event_tables(
    table, *, axis_name: str, h: int, E: int, tie_last: bool,
    emit_unclosed: bool, extras=(),
):
    """Stitch per-seq-shard GateEvents tables into the global table.

    Input: this shard's table with GLOBAL indices (each shard ran the fused
    kernel with `emit_unclosed=True` on its halo-extended block).  The only
    cross-shard interaction is the closed-form cluster rule: a shard's
    first gate continues the previous shard's trailing gate iff the above
    gap across the seam is <= h.  All per-shard tables are all-gathered
    (O(n_seq * E) scalars per stream) and merged with one lax.scan --
    identical output on every shard.

    Peak ties are index-aware ('last' -> larger index wins among equal
    values), which also makes the h-sample tracked-region overlap at each
    seam (see `sharded_minn_rtl_detect_fused`) harmless.
    """
    i32 = jnp.int32
    # pack EVERYTHING into ONE i32 buffer (f32 fields -- peak_value plus any
    # capture-at-peak side channels -- ride along bitcast to i32, losslessly
    # reversed after the gather) so the merge costs a single all_gather
    K = 1 + len(extras)
    fpacked = jnp.concatenate([table.peak_value, *extras], axis=-1)
    packed = jnp.concatenate(
        [
            table.gate_start, table.gate_close, table.peak_idx,
            table.closed.astype(i32),
            table.count[:, None], table.overflow.astype(i32)[:, None],
            jax.lax.bitcast_convert_type(fpacked, i32),
        ],
        axis=-1,
    )  # (B, (4 + K) * E + 2)
    gall = jax.lax.all_gather(packed, axis_name)  # (n_seq, B, (4+K)E+2)
    gf32 = jax.lax.bitcast_convert_type(
        gall[..., 4 * E + 2 :], jnp.float32
    )  # (n_seq, B, K*E)
    gathered = (
        gall[..., 0:E], gall[..., E : 2 * E], gall[..., 2 * E : 3 * E],
        gf32, gall[..., 3 * E : 4 * E].astype(bool),
        gall[..., 4 * E], gall[..., 4 * E + 1].astype(bool),
    )
    return merge_stacked_event_tables(
        gathered, h=h, E=E, K=K, tie_last=tie_last,
        emit_unclosed=emit_unclosed,
    )


def sharded_zc_detect(
    rx: jax.Array,
    mesh: Mesh,
    *,
    reference: jax.Array,
    corr_window: int = 2048,
    threshold_value: int | None = None,
    threshold_frac_bits: int = 15,
    min_corr_mag: float = 0.3,
    hysteresis: int = 256,
    max_events: int = 16,
    tie: str = "first",
    emit_unclosed: bool = True,
):
    """End-to-end sharded ZC streaming detection from complex IQ.

    rx: (batch, branches, L) complex, batch over 'data', L over 'seq'.
    Per shard: FFT matched filter + per-branch normalization (reference
    zc_v2.py:244-271, 486-498) over a (W + R - 1)-sample halo, then the
    CFAR threshold and collective event merge.  Events cover correlation
    outputs k in [0, L) -- the 'full'-convolution tail beyond the stream
    end is dropped -- and equal `models.detectors.ZCStreamingDetector.detect`
    on the unsharded magnitudes truncated to L (up to FFT float
    association; tests use clear peaks).

    The per-shard matched filter is an FFT convolution (cuFFT on a GPU):
    monolithic below 2^16 samples, overlap-save above.
    """
    from ofdm_sync_tpu.ops.channel import (
        fft_convolve_full, fft_convolve_full_ols,
    )
    from ofdm_sync_tpu.ops.detect import GateEvents

    ref = jnp.asarray(reference)
    R = ref.shape[-1]
    W = corr_window
    if threshold_value is None:
        threshold_value = int(4.0 * (1 << threshold_frac_bits) / W)
    batch, branches, n = rx.shape
    n_seq = mesh.shape["seq"]
    n_data = mesh.shape["data"]
    if n % n_seq or batch % n_data:
        raise ValueError("batch/stream dims not divisible by mesh axes")
    block = n // n_seq
    halo = W + R - 1
    if block < halo:
        raise ValueError(
            f"seq shard of {block} samples is shorter than the W+R-1="
            f"{halo} halo; use fewer seq shards"
        )
    kern = jnp.conj(ref[::-1])
    ref_norm = jnp.sqrt(jnp.sum(jnp.abs(ref) ** 2))
    h = max(int(hysteresis), 1)
    eps = jnp.float32(1e-12)

    def shard_fn(blk):
        # blk: (B_loc, BR, block) complex
        ext = halo_exchange(blk, halo, 0, "seq")
        # matched filter ('full' conv index k uses x[k-R+1 .. k]); slice so
        # lane i corresponds to windows ending at ext index R-1+i, i.e.
        # global correlation outputs [s*block - W, s*block + block).
        # long shards: overlap-save batched FFTs
        if ext.shape[-1] >= 1 << 16 and kern.ndim == 1:
            conv = fft_convolve_full_ols(ext, kern)
        else:
            conv = fft_convolve_full(ext, kern)
        num = conv[..., R - 1 : R - 1 + W + block]
        p = jnp.abs(ext) ** 2
        cs = jnp.cumsum(p, axis=-1)
        win = cs - jnp.concatenate(
            [jnp.zeros_like(cs[..., :R]), cs[..., :-R]], axis=-1
        )
        power = win[..., R - 1 : R - 1 + W + block]
        denom = ref_norm * jnp.sqrt(jnp.maximum(power, eps))
        corr = jnp.sum(num / denom, axis=1)  # (B_loc, W + block)
        mag = jnp.abs(corr).astype(jnp.float32)

        cs2 = jnp.cumsum(mag, axis=-1)
        local_sum = (cs2 - jnp.concatenate(
            [jnp.zeros_like(cs2[..., :W]), cs2[..., :-W]], axis=-1
        ))[..., W:]
        x_mag = mag[..., W:]  # (B_loc, block)

        sidx = jax.lax.axis_index("seq")
        gi = sidx * block + jnp.arange(block, dtype=jnp.int32)
        gi_b = jnp.broadcast_to(gi, x_mag.shape)
        valid = gi_b >= W
        above = (
            valid
            & (x_mag * jnp.float32(1 << threshold_frac_bits)
               >= local_sum * jnp.float32(threshold_value))
            & (x_mag >= jnp.float32(min_corr_mag))
        )
        return _cross_shard_event_merge(
            above, x_mag, gi_b, h=h, E=max_events, n=n,
            tie_last=(tie == "last"), emit_unclosed=emit_unclosed,
        )

    rep = P("data")
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("data", None, "seq"),),
        out_specs=(rep,) * 8,
        check_vma=False,
    )
    valid, closed, gs, gc, pi, pv, count, overflow = fn(rx)
    return GateEvents(
        valid=valid, closed=closed, gate_start=gs, gate_close=gc,
        peak_idx=pi, peak_value=pv, count=count, overflow=overflow,
    )


# ---------------------------------------------------------------------------
# Data-parallel sweep sharding
# ---------------------------------------------------------------------------

def shard_batch(x: jax.Array, mesh: Mesh, axis: int = 0) -> jax.Array:
    """Place a batched array with its leading axis sharded over 'data'."""
    spec = [None] * x.ndim
    spec[axis] = "data"
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


# ---------------------------------------------------------------------------
# Sharded device-side frame re-emission (the R4 output contract, multi-chip)
# ---------------------------------------------------------------------------

def _extract_local_frames(blk, table, *, shard_start, stream_len,
                          frame_len, timing_offset, max_frames):
    """One seq shard's contribution to every frame window.

    blk: this shard's (C, B_loc, block) slice of the stream; table fields
    (B_loc, E) with GLOBAL indices (the merged table is replicated over
    'seq').  Each output position of a window is held by exactly one seq
    shard, so contributions assemble with a single psum: the local block is
    zero-padded by frame_len on both sides and dynamically sliced at the
    clipped local offset -- positions outside this shard's span read the
    zero padding, never real samples, so cross-shard sums are exact.
    """
    C, B_loc, block = blk.shape
    E = table.peak_idx.shape[-1]
    K = min(max_frames, E)
    F = frame_len
    slot = jnp.arange(K, dtype=jnp.int32)
    valid = table.valid[:, :K] & (slot[None, :] < table.count[:, None])
    starts = jnp.clip(
        table.peak_idx[:, :K] + jnp.int32(timing_offset),
        0,
        max(stream_len - F, 0),
    ).astype(jnp.int32)  # (B_loc, K) global window starts

    padded = jnp.pad(blk, ((0, 0), (0, 0), (F, F)))  # (C, B_loc, block+2F)
    # local slice offset into the padded block: in [0, block + F] always
    off = jnp.clip(starts - shard_start, -F, block) + F

    def one_stream(pb, offs, oks):
        # pb: (C, block+2F); offs/oks: (K,)
        def one_slot(o, ok):
            win = jax.lax.dynamic_slice_in_dim(pb, o, F, axis=-1)
            return jnp.where(ok, win, jnp.zeros_like(win))

        return jax.vmap(one_slot)(offs, oks)  # (K, C, F)

    frames = jax.vmap(one_stream, in_axes=(1, 0, 0))(padded, off, valid)
    if K < max_frames:
        pad_n = max_frames - K
        frames = jnp.concatenate(
            [frames, jnp.zeros((B_loc, pad_n, C, F), frames.dtype)], axis=1
        )
        starts = jnp.concatenate(
            [starts, jnp.zeros((B_loc, pad_n), jnp.int32)], axis=1
        )
        valid = jnp.concatenate(
            [valid, jnp.zeros((B_loc, pad_n), bool)], axis=1
        )
    return frames, starts, valid


def sharded_extract_frames(
    iq: jax.Array,
    table,
    mesh: Mesh,
    *,
    frame_len: int,
    timing_offset: int = 0,
    max_frames: int = 4,
):
    """Device-side aligned frame re-emission on the SHARDED stream -- the
    RTL detector's output contract (circular buffer + timer queue,
    reference ref/minn_preamble_detector.sv:103-180, 445-530) completing
    the production multi-chip path: detect AND re-emit without ever
    materializing the stream on one chip.

    iq: (C, batch, L) channel-leading float32 (batch over 'data', L over
    'seq' -- the same layout the sharded detect paths consume); table: the
    merged `GateEvents` those paths return (fields (batch, E), batch over
    'data', replicated over 'seq').  Each window [start, start+frame_len)
    may span seq-shard seams: every shard contributes exactly the samples
    it holds (zero elsewhere) and one `psum` over 'seq' assembles the full
    windows -- no all_gather of the stream.

    Returns `(frames, starts, valid)` matching
    `ops.extract.extract_frames_batched` exactly: frames
    ``(batch, max_frames, C, frame_len)`` float32 (batch over 'data',
    replicated over 'seq'), zero where invalid.
    """
    C, batch, L = iq.shape
    n_seq = mesh.shape["seq"]
    n_data = mesh.shape["data"]
    if L % n_seq or batch % n_data:
        raise ValueError("batch/stream dims not divisible by mesh axes")
    block = L // n_seq

    def shard_fn(blk, valid_t, count_t, peak_t):
        sidx = jax.lax.axis_index("seq")
        from ofdm_sync_tpu.ops.detect import GateEvents

        tb = GateEvents(
            valid=valid_t, closed=valid_t, gate_start=peak_t,
            gate_close=peak_t, peak_idx=peak_t,
            peak_value=jnp.zeros_like(peak_t, jnp.float32),
            count=count_t, overflow=jnp.zeros_like(count_t, bool),
        )
        frames, starts, valid = _extract_local_frames(
            blk, tb, shard_start=sidx * block, stream_len=L,
            frame_len=frame_len, timing_offset=timing_offset,
            max_frames=max_frames,
        )
        frames = jax.lax.psum(frames, "seq")
        return frames, starts, valid

    rep = P("data")
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, "data", "seq"), rep, rep, rep),
        out_specs=(rep, rep, rep),
        check_vma=False,
    )
    return fn(iq, table.valid, table.count, table.peak_idx)


def sharded_minn_rtl_receive(
    iq: jax.Array,
    mesh: Mesh,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    frame_len: int,
    max_events: int = 8,
    timing_offset: int = 0,
    max_frames: int = 4,
    interpret: bool = False,
):
    """The Minn-RTL receive chain's front half over a mesh: sharded fused
    detection (`sharded_minn_rtl_detect_fused`) + sharded device-side
    aligned frame re-emission (`sharded_extract_frames`) -- detect AND
    re-emit without ever materializing the stream on one device.  Frame
    windows open at ``peak_idx + timing_offset`` and may span seq-shard
    seams (each shard contributes its samples; one psum assembles the
    window).

    The single-device counterpart is
    `models.detectors.MinnRTLDetector.detect_frames`, which opens windows
    at ``peak + params.timing_offset - 6*quarter_len`` (the RTL peak sits
    at s0 + 6Q -- reference minn_rtl.py:93-103, 943-953; output contract
    ref/minn_preamble_detector.sv:103-180, 445-530); pass that same value
    as `timing_offset` here.

    Returns ``(table, frames, starts, valid)`` -- the merged GateEvents
    plus frames ``(batch, max_frames, C, frame_len)`` float32, equal to
    the unsharded chain (tests assert).
    """
    table = sharded_minn_rtl_detect_fused(
        iq, mesh,
        quarter_len=quarter_len, smooth_shift=smooth_shift,
        threshold_value=threshold_value,
        threshold_frac_bits=threshold_frac_bits,
        hysteresis=hysteresis, max_events=max_events, interpret=interpret,
    )
    frames, starts, valid = sharded_extract_frames(
        iq.astype(jnp.float32), table, mesh,
        frame_len=frame_len, timing_offset=timing_offset,
        max_frames=max_frames,
    )
    return table, frames, starts, valid


# ---------------------------------------------------------------------------
# jit-cached entry points
# ---------------------------------------------------------------------------
# The public sharded entry points above build their shard_map closure per
# call; called eagerly, JAX re-traces and re-lowers the whole program EVERY
# call (~25 s for the TM detect path on the 8-device CPU test mesh -- the
# trace/lower, not XLA codegen, dominates).  Wrapping each in jax.jit with
# the mesh and every configuration keyword static makes JAX memoize the
# trace: repeated calls with the same (mesh, config, shapes) -- the shape of
# every production streaming loop, every test fuzz loop, and the driver
# dryrun -- dispatch the cached executable.  Semantics are unchanged
# (shape/config `raise`s now fire at trace time, i.e. still on the first
# call of any new combination), and the persistent compile cache applies on
# top across processes.

def _jit_entrypoint(fn, positional_statics=("mesh",)):
    import inspect

    sig = inspect.signature(fn)
    params = list(sig.parameters)
    argnums = tuple(
        params.index(n) for n in positional_statics if n in params
    )
    # every keyword-only parameter is configuration EXCEPT declared arrays
    array_kwargs = {"reference"}
    kwonly = tuple(
        p.name for p in sig.parameters.values()
        if p.kind is p.KEYWORD_ONLY and p.name not in array_kwargs
    )
    return jax.jit(
        fn,
        static_argnums=argnums,
        static_argnames=tuple(positional_statics) + kwonly,
    )


sharded_minn_rtl_metric = _jit_entrypoint(sharded_minn_rtl_metric)
sharded_aa_metric = _jit_entrypoint(sharded_aa_metric, ("mesh", "L"))
sharded_sc_metric = _jit_entrypoint(sharded_sc_metric, ("mesh", "n_fft"))
sharded_minn_rtl_planar = _jit_entrypoint(sharded_minn_rtl_planar)
sharded_minn_rtl_detect = _jit_entrypoint(sharded_minn_rtl_detect)
sharded_minn_rtl_detect_fused = _jit_entrypoint(sharded_minn_rtl_detect_fused)
sharded_zc_detect = _jit_entrypoint(sharded_zc_detect)
sharded_extract_frames = _jit_entrypoint(sharded_extract_frames)
# the receive chain composes two jitted stages; jit the composition too so
# the full chain is one cached dispatch
sharded_minn_rtl_receive = _jit_entrypoint(sharded_minn_rtl_receive)
