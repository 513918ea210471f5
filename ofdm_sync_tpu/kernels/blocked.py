"""Blocked prefix operations: compile-fast, tile-friendly scans for long axes.

XLA's log-depth lowering of cumsum / cummax / associative_scan over a very
long 1-D axis produces large programs whose compile time grows
super-linearly with the axis length.  Reshaping the stream into
(rows, BLOCK) and doing a two-level scan -- a short scan inside each 4096-pt
block plus a tiny cross-block carry scan -- keeps programs small and
compiles in seconds.

This is the "4096-pt block" processing shape named by the benchmark target
(BASELINE.md) applied to every prefix op in the hot path.  All functions
operate on the LAST axis and accept arbitrary leading batch axes; results
equal the unblocked ops up to float reassociation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BLOCK = 4096

#: lengths up to this use the plain single-level lowering
_SMALL = 2 * BLOCK


def lr_flat(a: jax.Array, b: jax.Array) -> jax.Array:
    """Plain log-depth solve of ``s[n] = a[n] s[n-1] + b[n]``, ``s[-1]=0``."""

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_l * a_r, b_l * a_r + b_r

    _, s = jax.lax.associative_scan(combine, (a, b), axis=-1)
    return s


def _pad_to_blocks(x: jax.Array, block: int, fill) -> tuple[jax.Array, int]:
    n = x.shape[-1]
    pad = (-n) % block
    if pad:
        tail = jnp.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype)
        x = jnp.concatenate([x, tail], axis=-1)
    return x, n


def cumsum(x: jax.Array, block: int = BLOCK) -> jax.Array:
    """Blocked inclusive cumsum along the last axis."""
    n = x.shape[-1]
    if n <= _SMALL:
        return jnp.cumsum(x, axis=-1)
    xp, n0 = _pad_to_blocks(x, block, 0)
    rows = xp.shape[-1] // block
    r = xp.reshape(xp.shape[:-1] + (rows, block))
    cs = jnp.cumsum(r, axis=-1)
    totals = cs[..., -1]
    offsets = jnp.cumsum(totals, axis=-1) - totals  # exclusive
    out = cs + offsets[..., None]
    return out.reshape(xp.shape)[..., :n0]


def cummax(x: jax.Array, block: int = BLOCK) -> jax.Array:
    """Blocked inclusive running maximum along the last axis."""
    n = x.shape[-1]
    if n <= _SMALL:
        return jax.lax.cummax(x, axis=x.ndim - 1)
    if jnp.issubdtype(x.dtype, jnp.integer):
        fill = jnp.iinfo(x.dtype).min
    else:
        fill = -jnp.inf
    xp, n0 = _pad_to_blocks(x, block, fill)
    rows = xp.shape[-1] // block
    r = xp.reshape(xp.shape[:-1] + (rows, block))
    cm = jax.lax.cummax(r, axis=r.ndim - 1)
    totals = cm[..., -1]
    run = jax.lax.cummax(totals, axis=totals.ndim - 1)
    # exclusive running max of preceding blocks
    prev = jnp.concatenate(
        [jnp.full(run.shape[:-1] + (1,), fill, run.dtype), run[..., :-1]], axis=-1
    )
    out = jnp.maximum(cm, prev[..., None])
    return out.reshape(xp.shape)[..., :n0]


def linear_recurrence(a: jax.Array, b: jax.Array, block: int = BLOCK) -> jax.Array:
    """Blocked solve of ``s[n] = a[n] s[n-1] + b[n]``, ``s[-1] = 0``.

    Within-block log-depth associative scan, then a cross-block carry scan of
    (prod a, last s) pairs, then ``s += carry_in * cumprod(a)`` per block.
    Note ``cumprod(a)`` underflows to 0 deep into a block for a < 1 -- which
    is exactly the (correct) f32 statement that the carry's influence has
    decayed below representability.
    """
    n = a.shape[-1]
    if n <= _SMALL:
        return lr_flat(a, b)
    ap, n0 = _pad_to_blocks(a, block, 1)
    bp, _ = _pad_to_blocks(b, block, 0)
    rows = ap.shape[-1] // block
    ar = ap.reshape(ap.shape[:-1] + (rows, block))
    br = bp.reshape(bp.shape[:-1] + (rows, block))

    s_local = lr_flat(ar, br)
    cum_a = jnp.cumprod(ar, axis=-1)
    A_tot = cum_a[..., -1]   # (..., rows)
    S_tot = s_local[..., -1]

    # carry into row k = sum_{j<k} S[j] * prod_{j<m<k} A[m]  (another linear
    # recurrence over the tiny rows axis)
    carry_incl = lr_flat(A_tot, S_tot)
    carry_in = jnp.concatenate(
        [jnp.zeros(carry_incl.shape[:-1] + (1,), carry_incl.dtype),
         carry_incl[..., :-1]],
        axis=-1,
    )
    out = s_local + carry_in[..., None] * cum_a
    return out.reshape(ap.shape)[..., :n0]
