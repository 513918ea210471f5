"""Channel emulation: measured-CIR FIR, AWGN, CFO, ADC quantization.

Array-first re-design of reference channel.py:15-98, core.py:123-138 and
sync_aa.py:263-315, 577-645:
  * the per-branch ``np.convolve`` (reference channel.py:95) becomes a single
    batched FFT convolution (one radix FFT over all branches at once);
  * noise can come from the host NumPy Generator (bit-parity with the
    reference seeds) or from the JAX threefry PRNG (device-resident, for
    batched sweeps);
  * CFO application and the 12-bit ADC model are pure jnp, vmappable over
    a config axis.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

_DATA_DIR = Path(__file__).resolve().parent.parent / "data"

#: Measured channel profiles: 1100-tap, 2-RX CIRs from CSV captures
#: (reference channel_models/cir{1,2}.csv via channel.py:9-12).
CHANNEL_PROFILES = ("cir1", "cir2")


@lru_cache(maxsize=None)
def load_measured_cir(name: str) -> np.ndarray:
    """Load the (n_rx, taps) complex CIR bank for a measured profile.

    Data ships as ``data/channels.npz`` (converted from the reference's CSV
    captures by tools/convert_reference_data.py; semantics of reference
    channel.py:15-48: NaN taps masked per RX channel, zero-padded to the
    longest channel).
    """
    path = _DATA_DIR / "channels.npz"
    if not path.exists():
        raise FileNotFoundError(
            f"{path} missing - run tools/convert_reference_data.py to build it"
        )
    with np.load(path) as z:
        if name not in z:
            raise ValueError(f"Unknown channel profile '{name}'")
        return z[name]


def parse_cir_csv(path: Path) -> np.ndarray:
    """Parse a raw CIR CSV (columns: delay, then (real, imag) per RX channel)
    into an (n_rx, taps) complex array -- reference channel.py:15-48 semantics."""
    data = np.genfromtxt(path, delimiter=",", skip_header=1)
    if data.ndim == 1:
        data = data[np.newaxis, :]
    num_channels = (data.shape[1] - 1) // 2
    cirs = []
    for chan in range(num_channels):
        real = data[:, 1 + 2 * chan]
        imag = data[:, 2 + 2 * chan]
        mask = np.isfinite(real) & np.isfinite(imag)
        cirs.append((real[mask] + 1j * imag[mask]).astype(np.complex128))
    if not cirs:
        raise ValueError(f"'{path}' contains no CIR taps")
    max_len = max(c.shape[0] for c in cirs)
    out = np.zeros((len(cirs), max_len), dtype=np.complex128)
    for i, c in enumerate(cirs):
        out[i, : c.shape[0]] = c
    return out


def compute_channel_peak_offset(cir) -> int:
    """Strongest-path index of an (n_rx, taps) CIR -- the ground-truth delay
    used for timing-error scoring (reference core.py:113-120)."""
    if cir is None:
        return 0
    agg = np.sum(np.abs(np.asarray(cir)) ** 2, axis=0)
    return int(np.argmax(agg)) if np.any(agg) else 0


# ---------------------------------------------------------------------------
# Batched FIR via FFT (replaces reference channel.py:95 np.convolve loop)
# ---------------------------------------------------------------------------

def _next_fast_len(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fft_convolve_full(x: jax.Array, taps: jax.Array) -> jax.Array:
    """Full linear convolution along the last axis via FFT.

    Broadcasts over leading axes: ``x`` (..., L) with ``taps`` (..., T)
    yields (..., L+T-1).  Used for both the channel FIR and the ZC matched
    filters (reference channel.py:95, zc.py:115-117, zc_v2.py:244-271).

    `fft_convolve_full_ols` is the overlap-save form for long streams;
    this form is kept as the bit-parity baseline.
    """
    L = x.shape[-1]
    T = taps.shape[-1]
    n = _next_fast_len(L + T - 1)
    X = jnp.fft.fft(x, n=n, axis=-1)
    H = jnp.fft.fft(taps, n=n, axis=-1)
    y = jnp.fft.ifft(X * H, axis=-1)[..., : L + T - 1]
    return y


def fft_convolve_full_ols(
    x: jax.Array, taps: jax.Array, block: int = 16384
) -> jax.Array:
    """Overlap-save full convolution: batched `block`-point FFTs instead of
    one monolithic (L+T-1)-point transform.

    Same output as `fft_convolve_full` up to f32 rounding (the FFT
    factorization differs).  ``taps`` must be 1-D
    here (the matched-filter case, reference zc_v2.py:244-271); use the
    monolithic form for per-branch CIR banks.
    """
    if taps.ndim != 1:
        raise ValueError("overlap-save form expects 1-D taps")
    L = x.shape[-1]
    T = taps.shape[-1]
    if block < 2 * T:
        raise ValueError(f"block {block} too small for {T} taps")
    lead = x.shape[:-1]
    step = block - T + 1
    n_out = L + T - 1
    nblk = -(-n_out // step)
    pad = jnp.pad(
        x.reshape(-1, L), ((0, 0), (T - 1, nblk * step - L))
    )
    idx = jnp.arange(nblk)[:, None] * step + jnp.arange(block)[None, :]
    blocks = pad[:, idx]                       # (B, nblk, block)
    H = jnp.fft.fft(taps, n=block)
    Y = jnp.fft.ifft(jnp.fft.fft(blocks, axis=-1) * H, axis=-1)
    y = Y[..., T - 1 :].reshape(-1, nblk * step)[:, :n_out]
    return y.reshape(*lead, n_out)


def apply_cir(signal: jax.Array, cir: jax.Array) -> jax.Array:
    """Convolve a 1-D signal with an (n_rx, taps) CIR bank -> (n_rx, L+T-1)."""
    sig = jnp.asarray(signal, jnp.complex64)[None, :]
    taps = jnp.asarray(cir, jnp.complex64)
    return fft_convolve_full(sig, taps)


# ---------------------------------------------------------------------------
# AWGN (reference channel.py:51-77)
# ---------------------------------------------------------------------------

def awgn_noise_host(
    signal: np.ndarray, snr_db: float, rng: np.random.Generator
) -> np.ndarray:
    """Complex AWGN using the host Generator with the reference's exact draw
    order (real then imag over the full shape) so seeded runs reproduce the
    reference scripts bit-for-bit (reference channel.py:51-77)."""
    signal = np.asarray(signal)
    snr_linear = 10 ** (snr_db / 10)
    if signal.ndim == 1:
        p = np.mean(np.abs(signal) ** 2)
        if p == 0:
            # NOTE: consumes no RNG draws, while an all-zero ROW of a 2-D
            # input still consumes full draws below -- both mirror the
            # reference exactly (reference channel.py:58-59 vs 71-77); the
            # asymmetry is part of the bit-for-bit draw-order contract
            return np.zeros_like(signal)
        std = np.sqrt(p / snr_linear / 2)
        return std * (rng.standard_normal(signal.shape) + 1j * rng.standard_normal(signal.shape))
    if signal.ndim != 2:
        raise ValueError("Signal must be 1D or 2D array")
    p = np.mean(np.abs(signal) ** 2, axis=1, keepdims=True)
    std = np.sqrt(p / snr_linear / 2)
    noise = std * (rng.standard_normal(signal.shape) + 1j * rng.standard_normal(signal.shape))
    noise[p.squeeze(axis=1) == 0] = 0
    return noise


def awgn_noise_device(
    key: jax.Array, signal: jax.Array, snr_db: jax.Array | float
) -> jax.Array:
    """Device-resident AWGN with per-branch power matching, JAX threefry.

    Statistically equivalent to `awgn_noise_host`; used by batched sweeps
    where host RNG would serialize the pipeline.
    """
    signal = jnp.asarray(signal)
    x = signal if signal.ndim == 2 else signal[None, :]
    snr_linear = 10.0 ** (jnp.asarray(snr_db) / 10.0)
    p = jnp.mean(jnp.abs(x) ** 2, axis=-1, keepdims=True)
    std = jnp.sqrt(p / snr_linear / 2)
    kr, ki = jax.random.split(key)
    noise = std * (
        jax.random.normal(kr, x.shape) + 1j * jax.random.normal(ki, x.shape)
    ).astype(jnp.complex64)
    noise = jnp.where(p > 0, noise, jnp.zeros((), jnp.complex64))
    return noise if signal.ndim == 2 else noise[0]


def apply_channel(
    signal: np.ndarray,
    snr_db: float,
    rng: np.random.Generator,
    cir: np.ndarray | None = None,
) -> np.ndarray:
    """Optional measured-CIR FIR then AWGN; always returns (branches, L)
    (reference channel.py:80-98).  FIR runs on device; noise on host for
    seed parity."""
    signal = np.asarray(signal)
    if cir is None:
        faded = signal[np.newaxis, :]
    else:
        cir = np.asarray(cir)
        if cir.ndim == 1:
            cir = cir[np.newaxis, :]
        faded = np.asarray(apply_cir(signal, cir))
    return faded + awgn_noise_host(faded, snr_db, rng)


def apply_channel_multi_antenna(
    tx: np.ndarray,
    snr_db: float,
    rng: np.random.Generator,
    channel_name: str | None = None,
    num_rx_antennas: int = 2,
) -> tuple[np.ndarray, np.ndarray | None, int]:
    """Multi-antenna channel: per-antenna CIR + per-antenna independent noise
    (reference sync_aa.py:577-634).  Returns (rx, cir|None, peak_offset)."""
    if channel_name is None:
        p = np.mean(np.abs(tx) ** 2)
        std = np.sqrt(p / (10 ** (snr_db / 10)) / 2)
        rx = np.zeros((num_rx_antennas, len(tx)), dtype=complex)
        for ant in range(num_rx_antennas):
            rx[ant] = tx + std * (
                rng.standard_normal(len(tx)) + 1j * rng.standard_normal(len(tx))
            )
        return rx, None, 0
    cir_bank = load_measured_cir(channel_name)
    if cir_bank.shape[0] >= num_rx_antennas:
        cir = cir_bank[:num_rx_antennas].copy()
    else:
        cir = np.tile(cir_bank, (num_rx_antennas // cir_bank.shape[0] + 1, 1))[
            :num_rx_antennas
        ]
    faded = np.asarray(apply_cir(tx, cir))
    rx = np.zeros_like(faded)
    for ant in range(num_rx_antennas):
        p = np.mean(np.abs(faded[ant]) ** 2)
        std = np.sqrt(p / (10 ** (snr_db / 10)) / 2)
        rx[ant] = faded[ant] + std * (
            rng.standard_normal(faded.shape[1]) + 1j * rng.standard_normal(faded.shape[1])
        )
    return rx, cir, compute_channel_peak_offset(cir)


# ---------------------------------------------------------------------------
# CFO (reference core.py:123-138)
# ---------------------------------------------------------------------------

def apply_cfo(samples: jax.Array, cfo_hz: float, fs_hz: float) -> jax.Array:
    """Multiply by ``exp(j 2 pi f n / fs)``; same tone across branches.

    cfo_hz/fs_hz must be static Python numbers.  The sample index is
    decomposed into 12-bit digits with per-digit phase coefficients
    pre-reduced mod 2*pi in double precision on the host, keeping the tone
    accurate (phase error ~1e-3 rad) for arbitrarily long streams: a plain
    float32 ``arange`` collapses past 2^24 samples (consecutive indices
    become equal) and the device computes in float32.
    """
    import math

    x = jnp.asarray(samples)
    L = x.shape[-1]
    if L == 0:
        return x
    two_pi = 2.0 * math.pi
    a = two_pi * float(cfo_hz) / float(fs_hz)
    idx = jnp.arange(L, dtype=jnp.int32)
    ph = jnp.zeros((L,), jnp.float32)
    for shift in range(0, max(int(L - 1).bit_length(), 1), 12):
        digit = ((idx >> shift) & 0xFFF).astype(jnp.float32)
        c = math.fmod(a * float(1 << shift), two_pi)
        ph = ph + jnp.mod(
            digit * jnp.float32(c), jnp.float32(two_pi)
        )
    tone = (jnp.cos(ph) + 1j * jnp.sin(ph)).astype(jnp.complex64)
    return x * tone


# ---------------------------------------------------------------------------
# 12-bit ADC model (reference sync_aa.py:263-315)
# ---------------------------------------------------------------------------

def quantize_adc(samples: jax.Array, full_scale: float, bits: int = 12) -> jax.Array:
    """Mid-tread signed quantizer with clipping, I and Q independently."""
    levels = 2 ** (bits - 1)
    x = jnp.asarray(samples)

    def q(v):
        v = jnp.clip(v / full_scale, -1.0, 1.0 - 1.0 / levels)
        return jnp.round(v * levels) / levels * full_scale

    return q(x.real) + 1j * q(x.imag)


def quantize_int(samples: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray, float]:
    """Auto-scaled integer quantization used by the RTL testbench
    (reference ref/test_minn_preamble_detector.py:150-161).
    Returns (int I, int Q, scale)."""
    min_val = -(1 << (width - 1))
    max_val = (1 << (width - 1)) - 1
    max_mag = np.max(np.abs(samples))
    scale = 1.0 if max_mag == 0 else (max_val - 1) / max_mag
    scaled = samples * scale
    re = np.clip(np.round(scaled.real), min_val, max_val).astype(np.int32)
    im = np.clip(np.round(scaled.imag), min_val, max_val).astype(np.int32)
    return re, im, scale


def compute_clipping_stats(samples: np.ndarray, full_scale: float, bits: int = 12) -> dict:
    """Clip fractions + effective bits (reference sync_aa.py:294-315)."""
    samples = np.asarray(samples)
    real_clip = np.sum(np.abs(samples.real) >= full_scale) / samples.size
    imag_clip = np.sum(np.abs(samples.imag) >= full_scale) / samples.size
    total_clip = (
        np.sum((np.abs(samples.real) >= full_scale) | (np.abs(samples.imag) >= full_scale))
        / samples.size
    )
    signal_rms = np.sqrt(np.mean(np.abs(samples) ** 2))
    effective_bits = bits + np.log2(signal_rms / full_scale) if full_scale > 0 else 0
    return {
        "real_clip_pct": 100 * real_clip,
        "imag_clip_pct": 100 * imag_clip,
        "total_clip_pct": 100 * total_clip,
        "effective_bits": max(0, effective_bits),
        "signal_rms": signal_rms,
        "full_scale": full_scale,
    }
