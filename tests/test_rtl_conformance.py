"""RTL-testbench-equivalent conformance for the Minn-RTL detector.

Reproduces the reference's only automated test
(reference ref/test_minn_preamble_detector.py): hermitian [A A -A -A]
preamble + QPSK symbol + guards, AWGN at 10 dB, int12 quantization, two
antennas -- then asserts our jitted detector flags the frame within the
reference's +-16 sample tolerance of the sequential float64 golden FSM.
The RTL simulator is replaced by our vectorized detector; the golden model
here plays the role the NumPy golden played against Verilator.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ofdm_sync_tpu.conformance.golden import golden_gate_events, golden_minn_rtl_metric
from ofdm_sync_tpu.models.detectors import MinnRTLDetector
from ofdm_sync_tpu.ops.channel import quantize_int
from ofdm_sync_tpu.ops.waveforms import (
    build_hermitian_minn_preamble,
    build_random_qpsk_symbol,
)
from ofdm_sync_tpu.params import MinnRTLParams, SystemParams

# testbench constants (reference ref/test_minn_preamble_detector.py:27-38)
INPUT_WIDTH = 12
NFFT = 2048
CP_LEN = 512
THRESH_VALUE = int(0.1 * (1 << 15))
SMOOTH_SHIFT = 3
HYSTERESIS = 2
LEADING_GUARD = 256
TRAILING_GUARD = NFFT + CP_LEN
AWGN_SNR_DB = 10.0
TOLERANCE = 16  # reference ref/test_minn_preamble_detector.py:446-451


def _testbench_stimulus():
    sys = SystemParams(n_fft=NFFT, cp_len=CP_LEN)
    params = sys
    preamble, _ = build_hermitian_minn_preamble(params, include_cp=True)
    rng_sym = np.random.default_rng()  # testbench uses unseeded generator here
    data_symbol, _ = build_random_qpsk_symbol(np.random.default_rng(1), params)
    base = np.concatenate((preamble, data_symbol))
    full = np.concatenate(
        (np.zeros(LEADING_GUARD, complex), base, np.zeros(TRAILING_GUARD, complex))
    )
    rng = np.random.default_rng(0)

    def add_awgn(x):
        p = np.mean(np.abs(x) ** 2)
        sigma = np.sqrt(p / (10 ** (AWGN_SNR_DB / 10)) / 2)
        return x + rng.normal(0, sigma, x.shape) + 1j * rng.normal(0, sigma, x.shape)

    ch0 = add_awgn(full)
    ch1 = add_awgn(full)
    i0, q0, _ = quantize_int(ch0, INPUT_WIDTH)
    i1, q1, _ = quantize_int(ch1, INPUT_WIDTH)
    rx = np.stack([i0 + 1j * q0, i1 + 1j * q1]).astype(np.complex128)
    return rx


def _golden_flag_index(rx) -> int:
    """Sequential float64 golden FSM (the testbench's `minn_reference` role)."""
    state = golden_minn_rtl_metric(rx, NFFT // 4, SMOOTH_SHIFT, THRESH_VALUE, 15)
    events = golden_gate_events(
        state["above"],
        state["smooth"],
        HYSTERESIS,
        tie="last",
        emit_unclosed=False,
        valid_from=3 * (NFFT // 4) - 1,
    )
    assert events, "golden detector did not trigger"
    return events[0][2]  # peak index of first closed gate


@pytest.fixture(scope="module")
def stimulus():
    return _testbench_stimulus()


def test_detector_flags_within_tolerance(stimulus):
    rx = stimulus
    golden_idx = _golden_flag_index(rx)
    det = MinnRTLDetector(
        SystemParams(n_fft=NFFT, cp_len=CP_LEN),
        MinnRTLParams(
            quarter_len=NFFT // 4,
            smooth_shift=SMOOTH_SHIFT,
            threshold_value=THRESH_VALUE,
            hysteresis=HYSTERESIS,
        ),
    )
    _, result = det.detect(jnp.asarray(rx, jnp.complex64))
    assert result.events, "detector did not trigger"
    observed = result.events[0].peak_index
    assert abs(observed - golden_idx) <= TOLERANCE, (
        f"observed {observed} vs golden {golden_idx}"
    )


def test_detector_peak_near_pilot_n_start(stimulus):
    """The RTL peak lands ~1Q after preamble end == data N-start
    (reference minn_rtl.py:60-106 doc header)."""
    rx = stimulus
    det = MinnRTLDetector(
        SystemParams(n_fft=NFFT, cp_len=CP_LEN),
        MinnRTLParams(
            quarter_len=NFFT // 4,
            smooth_shift=SMOOTH_SHIFT,
            threshold_value=THRESH_VALUE,
            hysteresis=HYSTERESIS,
        ),
    )
    _, result = det.detect(jnp.asarray(rx, jnp.complex64))
    # preamble with CP: starts at 256, length CP+N = 2560; data N-start at
    # 256 + 2560 + 512 = 3328
    expected = LEADING_GUARD + CP_LEN + NFFT + CP_LEN
    assert abs(result.events[0].peak_index - expected) <= TOLERANCE


def test_int12_quantization_scale(stimulus):
    rx = stimulus
    assert np.max(np.abs(rx.real)) <= 2047
    assert np.max(np.abs(rx.imag)) <= 2047
    assert np.max(np.abs(rx.real)) > 1024  # auto-scaling used most of the range
