"""Checks of the compiled main path against its plain references.

Shared by `chip_smoke.py` (compiled, on the card) and
`__graft_entry__.dryrun_multichip` (Pallas interpreter, virtual CPU
devices), so the rehearsal and the four-card run execute the same code.

Stimulus discipline (the RTL-vs-golden triangle of the reference testbench,
ref/test_minn_preamble_detector.py:446-451): integer-valued IQ small enough
that every window sum -- and every prefix sum the XLA reference takes over a
whole stream -- stays below 2^24, so corr/energy are exact in float32 on
every route and any table mismatch is a real divergence, not reduction-order
noise.
"""

from __future__ import annotations

import numpy as np

#: integer GateEvents fields, compared exactly
INT_FIELDS = ("valid", "closed", "gate_start", "gate_close", "peak_idx",
              "count", "overflow")


def table_diff(ref, out, *, name: str, pv_rtol: float = 1e-5) -> list[str]:
    """Field-by-field event-table comparison: integer fields exactly,
    `peak_value` to `pv_rtol`.  Returns mismatch descriptions."""
    errs = []
    for f in INT_FIELDS:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(out, f))
        if a.shape != b.shape or not np.array_equal(a, b):
            bad = int(np.sum(a != b)) if a.shape == b.shape else -1
            errs.append(f"{name}: field {f} differs ({bad} entries)")
    a = np.asarray(ref.peak_value, np.float64)
    b = np.asarray(out.peak_value, np.float64)
    if a.shape != b.shape or not np.allclose(b, a, rtol=pv_rtol, atol=0.0):
        errs.append(f"{name}: peak_value differs beyond rtol {pv_rtol}")
    return errs


def minn_stimulus(batch: int, L: int, quarter_len: int, *, seed: int = 0,
                  every: int = 8, dtype=None):
    """Channel-leading (4, batch, L) integer-valued float32 IQ (2 branches)
    on the default device: round(1.5 N(0,1)) noise with two 5Q preambles
    (the [-A,+A,+A,-A,-A] structure of minn_rtl.py:335-429, amplitude ~4)
    in every `every`-th stream, a third of them straddling L/4 and L/2 (the
    kernel's segment seams and the shard seams of a 4-way split)."""
    import jax
    import jax.numpy as jnp

    Q = quarter_len
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(Q) + 1j * rng.standard_normal(Q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    planes = np.stack(
        [np.round(4 * pre.real), np.round(4 * pre.imag)] * 2
    ).astype(np.float32)  # (4, 5Q)
    streams = np.arange(0, batch, every)
    pos = rng.integers(3 * Q, L - 6 * Q, size=(len(streams), 2))
    pos[::3, 0] = L // 4 - 2 * Q
    pos[1::3, 1] = L // 2 - 3 * Q + 1

    @jax.jit
    def build(key):
        x = jnp.round(
            1.5 * jax.random.normal(key, (4, batch, L), jnp.float32)
        )
        idx = jnp.arange(5 * Q)
        for k in range(2):
            x = x.at[
                :, jnp.asarray(streams)[:, None],
                jnp.asarray(pos[:, k])[:, None] + idx[None, :],
            ].add(jnp.asarray(planes)[:, None, :])
        return x if dtype is None else x.astype(dtype)

    return build(jax.random.key(seed))


def sharded_detection_errors(x, devices, kw: dict, *,
                             interpret: bool = False) -> dict:
    """`sharded_minn_rtl_detect_fused` over 'seq' on mesh (1, n) and over
    'data' on mesh (n, 1) against the single-device table computed on
    ``devices[0]`` in this process.  x: (C, batch, L) with L and batch
    divisible by n.  Returns {mesh name: mismatch list}."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ofdm_sync_tpu.kernels.minn_rtl_triton import minn_rtl_detect
    from ofdm_sync_tpu.parallel.shard import (
        make_stream_mesh, sharded_minn_rtl_detect_fused,
    )

    n = len(devices)
    ref = jax.jit(lambda v: minn_rtl_detect(v, **kw, interpret=interpret))(
        jax.device_put(x, devices[0])
    )
    out = {}
    for name, (nd, ns) in (("seq", (1, n)), ("data", (n, 1))):
        mesh = make_stream_mesh(nd, ns, devices=devices)
        xs = jax.device_put(x, NamedSharding(mesh, P(None, "data", "seq")))
        tab = sharded_minn_rtl_detect_fused(xs, mesh, **kw,
                                            interpret=interpret)
        out[f"{name} mesh ({nd}, {ns})"] = table_diff(
            ref, tab, name=f"sharded over {name}"
        )
    return out


def sharded_receive_errors(rx, devices, detector, *, frame_len: int,
                           L: int, interpret: bool = False) -> list[str]:
    """The sharded receive chain (`sharded_minn_rtl_receive`, mesh (1, n))
    against `detector` on ``devices[0]``: equal tables, equal frame
    windows.  rx: (branches, <=L) complex, zero-padded to L here; place a
    frame across a seam (L / n) to exercise the psum assembly."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ofdm_sync_tpu.parallel.shard import (
        make_stream_mesh, sharded_minn_rtl_receive,
    )

    rxp = np.zeros((rx.shape[0], L), np.complex64)
    rxp[:, : rx.shape[-1]] = rx
    planar = np.stack([rxp.real, rxp.imag], axis=1).reshape(-1, L)
    with jax.default_device(devices[0]):
        ref_tab = detector.detect_batch(
            jnp.asarray(planar[:, None]), interpret=interpret
        )
        _, frames, starts, valid = detector.detect_frames(
            rxp, frame_len=frame_len, interpret=interpret
        )
    mesh = make_stream_mesh(1, len(devices), devices=devices)
    xs = jax.device_put(
        jnp.asarray(planar[:, None]),
        NamedSharding(mesh, P(None, "data", "seq")),
    )
    p = detector.params
    tab, s_frames, s_starts, s_valid = sharded_minn_rtl_receive(
        xs, mesh, quarter_len=p.quarter_len, smooth_shift=p.smooth_shift,
        threshold_value=p.threshold_value,
        threshold_frac_bits=p.threshold_frac_bits, hysteresis=p.hysteresis,
        frame_len=frame_len, max_events=detector.max_events,
        timing_offset=p.timing_offset - 6 * p.quarter_len,
        interpret=interpret,
    )
    errs = table_diff(ref_tab, tab, name="sharded receive table")
    for name, a, b in (("frames", frames, s_frames[0]),
                       ("starts", starts, s_starts[0]),
                       ("valid", valid, s_valid[0])):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            errs.append(f"sharded receive: {name} differ")
    if not np.asarray(valid).any():
        errs.append("sharded receive: no frame detected")
    return errs
