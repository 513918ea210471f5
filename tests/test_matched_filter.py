"""The XLA matched filters (`ops.metrics.matched_filter`: one monolithic FFT,
or overlap-save in fixed-size blocks) against a direct NumPy convolution,
and the batched ZC detector built on them.

On a GPU both forms run through cuFFT in float32; the direct convolution
here is float64, so the tolerance is the float32 FFT's rounding (a few
1e-6 of the largest output)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ofdm_sync_tpu.ops import metrics as M


def _direct(x, ref):
    """Per-branch full correlation with the conjugate-reversed reference,
    in float64 (`np.convolve`)."""
    taps = np.conj(ref[::-1])
    return np.stack([np.convolve(b, taps) for b in x])


def _ints(rng, shape, scale):
    return (np.round(scale * rng.standard_normal(shape))
            + 1j * np.round(scale * rng.standard_normal(shape)))


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("T", [1, 62, 129, 2048, 2049])
@pytest.mark.parametrize("block", [None, 8192])
def test_matched_filter_matches_direct(rng, T, block):
    """Tap counts from a single tap to just past the 2048-sample PSS."""
    if block is not None and block < 2 * T:
        block = 16384
    x = _ints(rng, (2, 6000), 6.0)
    ref = _ints(rng, (T,), 16.0)
    got = M.matched_filter(jnp.asarray(x, jnp.complex64),
                           jnp.asarray(ref, jnp.complex64), block)
    assert got.shape == (2, 6000 + T - 1)
    assert _rel_err(got, _direct(x, ref)) < 2e-5


@pytest.mark.parametrize("L", [5000, 14335, 14336, 14337, 28709])
def test_matched_filter_ols_block_seams(rng, L):
    """Stream lengths on, just before and just after an overlap-save block
    seam (block 16384, 2048 taps: step 14337), and a ragged last block."""
    T = 2048
    x = _ints(rng, (1, L), 4.0)
    ref = _ints(rng, (T,), 8.0)
    want = _direct(x, ref)
    for block in (None, 16384):
        got = M.matched_filter(jnp.asarray(x, jnp.complex64),
                               jnp.asarray(ref, jnp.complex64), block)
        assert _rel_err(got, want) < 2e-5


def test_matched_filter_batched_leading_axes(rng):
    """(batch, branches, L) input: overlap-save keeps the leading axes."""
    x = _ints(rng, (3, 2, 4000), 4.0)
    ref = _ints(rng, (300,), 8.0)
    got = np.asarray(M.matched_filter(jnp.asarray(x, jnp.complex64),
                                      jnp.asarray(ref, jnp.complex64), 2048))
    for b in range(3):
        assert _rel_err(got[b], _direct(x[b], ref)) < 2e-5


def test_overlap_save_rejects_small_blocks(rng):
    from ofdm_sync_tpu.ops.channel import fft_convolve_full_ols

    with pytest.raises(ValueError, match="too small"):
        fft_convolve_full_ols(jnp.ones((1, 100), jnp.complex64),
                              jnp.ones((64,), jnp.complex64), 100)
