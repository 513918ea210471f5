"""Planar-float streaming detector datapaths (XLA).

Complex IQ is stored as PLANAR float32 (separate I and Q planes):
  * the device has no complex ALU -- XLA decomposes complex math to float
    pairs anyway, and planar rows are what the fused kernel reads;
  * the Minn-RTL correlation is real-valued by construction
    (``quarter_product = i*i_d + q*q_d``, reference
    ref/minn_antenna_path.sv:85-101), so the flagship path never needs a
    complex multiply at all.

Shapes are (..., 2, L): leading batch axes, then the I/Q plane axis, then
time.  These functions are jit/vmap/shard_map-friendly; they are the plain
reference the fused kernel is checked against and the route on backends
without it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ofdm_sync_tpu.ops.windows import (
    exp_smooth_shift,
    running_sum_stream,
    shift_right,
)
from ofdm_sync_tpu.ops.detect import extract_gate_events, GateEvents


def to_planar(x: jax.Array) -> jax.Array:
    """complex (..., L) -> planar float32 (..., 2, L)."""
    return jnp.stack([x.real, x.imag], axis=-2).astype(jnp.float32)


def from_planar(p: jax.Array) -> jax.Array:
    return (p[..., 0, :] + 1j * p[..., 1, :]).astype(jnp.complex64)


class MinnRTLFastState(NamedTuple):
    corr_positive: jax.Array    # (..., L) float32
    smooth_metric: jax.Array
    energy_total: jax.Array
    above_threshold: jax.Array  # bool
    valid_from: int


def minn_rtl_metric_planar(
    iq: jax.Array,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
) -> MinnRTLFastState:
    """Planar-float Minn-RTL metric, branch axis = -3.

    iq: (branches, 2, L) float32 (or batched (..., branches, 2, L)).
    Numerically identical to `ops.metrics.minn_rtl_metric` on the same data
    (the complex path also reduces to these real products).
    """
    Q = quarter_len
    i = iq[..., 0, :]
    q = iq[..., 1, :]
    i_d = shift_right(i, Q)
    q_d = shift_right(q, Q)
    quarter_product = i * i_d + q * q_d
    power = i * i + q * q

    corr = running_sum_stream(quarter_product, Q)
    energy = running_sum_stream(power, Q)
    corr_total = corr + shift_right(corr, Q)
    energy_total = energy + shift_right(energy, Q) + shift_right(energy, 2 * Q)
    # combine branches (axis -2 after the plane axis was consumed)
    corr_total = jnp.sum(corr_total, axis=-2)
    energy_total = jnp.sum(energy_total, axis=-2)
    corr_positive = jnp.maximum(corr_total, 0.0)

    valid_from = max(0, 3 * Q - 1)
    n = corr_positive.shape[-1]
    metric_valid = jnp.arange(n) >= valid_from
    smooth = exp_smooth_shift(corr_positive, smooth_shift, update_mask=metric_valid)

    corr_scaled = smooth * (1 << threshold_frac_bits)
    energy_scaled = energy_total * float(threshold_value)
    above = metric_valid & (corr_scaled >= energy_scaled)
    return MinnRTLFastState(
        corr_positive=corr_positive,
        smooth_metric=smooth,
        energy_total=energy_total,
        above_threshold=above,
        valid_from=valid_from,
    )


def minn_rtl_detect_planar(
    iq: jax.Array,
    *,
    quarter_len: int,
    smooth_shift: int,
    threshold_value: int,
    threshold_frac_bits: int,
    hysteresis: int,
    max_events: int = 8,
) -> tuple[MinnRTLFastState, GateEvents]:
    """Full fused metric + gate/peak event extraction (1 stream)."""
    state = minn_rtl_metric_planar(
        iq,
        quarter_len=quarter_len,
        smooth_shift=smooth_shift,
        threshold_value=threshold_value,
        threshold_frac_bits=threshold_frac_bits,
    )
    table = extract_gate_events(
        state.above_threshold,
        state.corr_positive,
        hysteresis=hysteresis,
        max_events=max_events,
        valid_from=state.valid_from,
        tie="last",
        emit_unclosed=False,
    )
    return state, table


class AAFastState(NamedTuple):
    P_re: jax.Array
    P_im: jax.Array
    R: jax.Array
    M: jax.Array
    valid: jax.Array


def aa_metric_planar(iq: jax.Array, L: int) -> AAFastState:
    """Planar-float [A][A] metric: P split into re/im planes.

    ``P = sum_window x[n] conj(x[n-L])``:
      re = i*i_d + q*q_d,  im = q*i_d - i*q_d.
    """
    i = iq[..., 0, :]
    q = iq[..., 1, :]
    i_d = shift_right(i, L)
    q_d = shift_right(q, L)
    n = i.shape[-1]
    live = jnp.arange(n) >= L
    pre = (i * i_d + q * q_d) * live
    pim = (q * i_d - i * q_d) * live
    power = i * i + q * q
    P_re = jnp.sum(running_sum_stream(pre, L), axis=-2)
    P_im = jnp.sum(running_sum_stream(pim, L), axis=-2)
    R = jnp.sum(running_sum_stream(power, L), axis=-2)
    valid = jnp.arange(n) >= L
    noise_floor = 1e-6 * L
    M = jnp.where(
        valid & (R > noise_floor),
        jnp.minimum((P_re**2 + P_im**2) / jnp.maximum(R, 1e-12) ** 2, 1.0),
        0.0,
    )
    return AAFastState(P_re=P_re, P_im=P_im, R=R, M=M, valid=valid)
