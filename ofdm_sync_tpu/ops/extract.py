"""Device-side aligned frame re-emission (the RTL detector's output side).

The reference RTL detector does not stop at an event: it re-emits the
delayed sample stream with a ``frame_start`` pulse aligned to the detected
preamble, via a circular sample buffer of depth ``NFFT + OUTPUT_MARGIN``
and a 4-deep detection *timer queue* (``ring_distance`` / ``fill_gap``
arithmetic, reference ref/minn_preamble_detector.sv:103-180, 389-417,
445-530; pulse position = peak + ``TIMING_OFFSET`` = -CP by default,
minn_preamble_detector.sv:8-19).

The array re-expression: the "circular buffer" is the device-resident IQ
stream itself, the "timer queue" is the detectors' capacity-bounded event
table, and re-emission is a batched dynamic-slice that gathers one
CP-aligned frame window per valid event — on device, planar float32 out
(the detectors' native layout).  Capacity is static
(``max_frames``, default 4 = the RTL queue depth); extra events overflow
exactly as the RTL's queue would.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ofdm_sync_tpu.ops.detect import GateEvents


@functools.partial(
    jax.jit, static_argnames=("frame_len", "timing_offset", "max_frames")
)
def extract_frames(
    iq: jax.Array,
    table: GateEvents,
    *,
    frame_len: int,
    timing_offset: int = 0,
    max_frames: int = 4,
):
    """Emit aligned frame windows from an event table, on device.

    iq: planar ``(C, L)`` float32 stream (C channel rows, e.g.
    ``[b0_i, b0_q, b1_i, b1_q]``).  table: a single-stream `GateEvents`
    (fields shaped ``(max_events,)``).  For each of the first
    ``max_frames`` valid events, gathers ``frame_len`` samples starting at
    ``peak_idx + timing_offset`` (clipped into the stream; the RTL uses
    ``TIMING_OFFSET = -CP`` so the window opens at the start of the cyclic
    prefix, minn_preamble_detector.sv:16-19, 445-530).

    Returns ``(frames, starts, valid)``:
      frames: ``(max_frames, C, frame_len)`` float32, zero where invalid;
      starts: ``(max_frames,)`` int32 global index of each window's first
        sample (clipped);
      valid:  ``(max_frames,)`` bool — slot holds a real detection.

    Batched streams: use `extract_frames_batched` (or ``jax.vmap`` over a
    ``functools.partial`` of this function) over a leading axis of both
    ``iq`` and the table.
    """
    C, L = iq.shape
    E = table.peak_idx.shape[-1]
    K = min(max_frames, E)
    slot = jnp.arange(K, dtype=jnp.int32)
    valid = table.valid[:K] & (slot < table.count)
    starts = jnp.clip(
        table.peak_idx[:K] + jnp.int32(timing_offset),
        0,
        max(L - frame_len, 0),
    ).astype(jnp.int32)

    def one(start, ok):
        win = jax.lax.dynamic_slice_in_dim(iq, start, frame_len, axis=-1)
        return jnp.where(ok, win, jnp.zeros_like(win))

    frames = jax.vmap(one)(starts, valid)  # (K, C, frame_len)
    if K < max_frames:
        pad = max_frames - K
        frames = jnp.concatenate(
            [frames, jnp.zeros((pad, C, frame_len), frames.dtype)], axis=0
        )
        starts = jnp.concatenate(
            [starts, jnp.zeros((pad,), jnp.int32)], axis=0
        )
        valid = jnp.concatenate(
            [valid, jnp.zeros((pad,), bool)], axis=0
        )
    return frames, starts, valid


@functools.partial(
    jax.jit, static_argnames=("frame_len", "timing_offset", "max_frames")
)
def extract_frames_batched(
    iq: jax.Array,
    table: GateEvents,
    *,
    frame_len: int,
    timing_offset: int = 0,
    max_frames: int = 4,
):
    """Batched form: iq ``(batch, C, L)``, table fields ``(batch, E)`` →
    frames ``(batch, max_frames, C, frame_len)`` (+ starts/valid per
    stream)."""
    fn = functools.partial(
        extract_frames,
        frame_len=frame_len,
        timing_offset=timing_offset,
        max_frames=max_frames,
    )
    return jax.vmap(fn)(iq, table)
