"""Detector model families: configured, jit-compiled detector objects.

One class per reference detector family (reference SURVEY section 2.2):

  SCDetector            D1  reference sc.py
  MinnDetector          D2  reference minn.py
  MinnRTLDetector       D3  reference minn_rtl.py + ref/*.sv
  ParkDetector          D4  reference park.py
  ZCTimeDetector        D5  reference zc.py
  ZCFreqDetector        D6  reference zc_freq.py
  ZCStreamingDetector   D7  reference zc_v2.py
  CombinedSCMinnDetector D8 reference combined_sc_min.py
  AADetector            D9  reference sync_aa.py

Each exposes `metric(rx)` (jittable, device-resident) and `detect(rx)`
(metric + event extraction; returns host-side DetectionResult).  All accept
rx shaped (L,) or (branches, L).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ofdm_sync_tpu.params import (
    AADetectorParams,
    MinnDetectorParams,
    MinnRTLParams,
    SCDetectorParams,
    SystemParams,
    SYS_30M72,
    SYS_AA_10M,
    ZCParams,
    ZCStreamingParams,
)
from ofdm_sync_tpu.models.base import DetectionEvent, DetectionResult, events_from_table
from ofdm_sync_tpu.ops import metrics as M
from ofdm_sync_tpu.ops.detect import (
    GateEvents, extract_gate_events, gate_open_mask,
)
from ofdm_sync_tpu.ops.waveforms import (
    build_pss_symbol,
    centered_subcarrier_indices,
    generate_zadoff_chu,
)

_C64 = jnp.complex64
#: overlap-save block of `ZCStreamingDetector.detect_batch`: the fastest of
#: 8192-65536 for the 2048-tap PSS filter on an H100 (PERF.md)
OLS_BLOCK = 16384


def _dev(rx) -> jax.Array:
    x = jnp.asarray(rx, _C64)
    return x[None, :] if x.ndim == 1 else x


def _planar(rx) -> jax.Array:
    """Complex (L,) / (B, L) -> planar float32 (2B, L), rows
    [b0_re, b0_im, b1_re, b1_im, ...]."""
    x = _dev(rx)
    return jnp.stack(
        [jnp.real(x), jnp.imag(x)], axis=1
    ).reshape(2 * x.shape[0], x.shape[-1]).astype(jnp.float32)


# ---------------------------------------------------------------------------
# D1: Schmidl & Cox
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SCDetector:
    sys: SystemParams = SYS_30M72
    params: SCDetectorParams = SCDetectorParams()

    def metric(self, rx):
        return M.sc_metric(_dev(rx), self.sys.n_fft)

    @partial(jax.jit, static_argnums=0)
    def _detect_jit(self, rx):
        Mm, P, R = M.sc_metric(rx, self.sys.n_fft)
        plateau_end = M.find_plateau_end(
            Mm,
            self.sys.cp_len,
            lookahead=self.sys.cp_len // 4,
            smooth_win=self.params.smooth_win,
            plateau_frac=self.params.plateau_frac,
            run_threshold=self.params.run_threshold,
        )
        coarse = jnp.maximum(plateau_end - self.params.sc_delta, 0)
        return Mm, P, R, plateau_end, coarse

    def detect(self, rx):
        Mm, P, R, plateau_end, coarse = self._detect_jit(_dev(rx))
        return {
            "M": Mm,
            "P": P,
            "R": R,
            "plateau_end": int(plateau_end),
            "coarse_start": int(coarse),
        }


# ---------------------------------------------------------------------------
# D2: standard Minn
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MinnDetector:
    sys: SystemParams = SYS_30M72
    params: MinnDetectorParams = MinnDetectorParams()
    #: override symbol length for block-length sweeps (reference minn.py:656-751)
    symbol_len: int | None = None

    @property
    def n(self) -> int:
        return self.symbol_len or self.sys.n_fft

    def metric(self, rx):
        return M.minn_metric(_dev(rx), self.n)

    @partial(jax.jit, static_argnums=0)
    def _detect_jit(self, rx):
        Mm, P, R = M.minn_metric(rx, self.n)
        peak, gate, Ms = M.find_minn_peak_standard(
            Mm, self.params.smooth_win, self.params.gate_threshold
        )
        return Mm, P, R, peak, gate, Ms

    def detect(self, rx):
        Mm, P, R, peak, gate, Ms = self._detect_jit(_dev(rx))
        return {
            "M": Mm,
            "P": P,
            "R": R,
            "peak": int(peak),
            "gate_mask": np.asarray(gate),
            "M_smooth": Ms,
        }


# ---------------------------------------------------------------------------
# D3: Minn-RTL adjacent-quarter (the flagship / benchmark detector)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MinnRTLDetector:
    sys: SystemParams = SYS_30M72
    params: MinnRTLParams = MinnRTLParams()
    max_events: int = 8

    def metric(self, rx) -> M.MinnRTLMetricState:
        return self._metric_jit(_dev(rx))

    @partial(jax.jit, static_argnums=0)
    def _metric_jit(self, rx):
        return M.minn_rtl_metric(
            rx,
            smooth_shift=self.params.smooth_shift,
            threshold_value=self.params.threshold_value,
            threshold_frac_bits=self.params.threshold_frac_bits,
            quarter_len=self.params.quarter_len,
        )

    @partial(jax.jit, static_argnums=0)
    def _detect_jit(self, rx):
        state = M.minn_rtl_metric(
            rx,
            smooth_shift=self.params.smooth_shift,
            threshold_value=self.params.threshold_value,
            threshold_frac_bits=self.params.threshold_frac_bits,
            quarter_len=self.params.quarter_len,
        )
        # the gate FSM peak-tracks corr_positive with a `>=` update
        # (reference minn_rtl.py:771-813)
        table = extract_gate_events(
            state.above_threshold,
            state.corr_positive,
            hysteresis=self.params.hysteresis,
            max_events=self.max_events,
            valid_from=M.minn_rtl_valid_from(self.params.quarter_len),
            tie="last",
            emit_unclosed=False,
        )
        gmask = gate_open_mask(
            state.above_threshold,
            self.params.hysteresis,
            M.minn_rtl_valid_from(self.params.quarter_len),
        )
        return state, table, gmask

    def detect(self, rx) -> tuple[M.MinnRTLMetricState, DetectionResult]:
        x = _dev(rx)
        state, table, gmask = self._detect_jit(x)
        n = x.shape[-1]
        events = [
            DetectionEvent(
                detected_start=e["peak_index"] + self.params.timing_offset, **e
            )
            for e in events_from_table(table, n, gate_end_mode="close_excl")
        ]
        return state, DetectionResult(events=events, gate_mask=np.asarray(gmask))

    def _kernel_kw(self) -> dict:
        p = self.params
        return dict(
            quarter_len=p.quarter_len, smooth_shift=p.smooth_shift,
            threshold_value=p.threshold_value,
            threshold_frac_bits=p.threshold_frac_bits,
            hysteresis=p.hysteresis, max_events=self.max_events,
        )

    def detect_batch(self, x, *, interpret: bool = False) -> GateEvents:
        """Event tables of a batch of streams (the throughput path).

        x: (2*branches, batch, L) channel-leading planar IQ, rows
        [b0_i, b0_q, b1_i, b1_q, ...], float32 or int16 (ADC samples).
        Returns `GateEvents` with (batch, max_events) fields, equal to
        `detect` run per stream.  On a GPU the fused Triton kernel
        (`kernels.minn_rtl_triton`) computes them; elsewhere the XLA
        datapath does (`interpret=True` runs the kernel in the Pallas
        interpreter instead, for tests).
        """
        from ofdm_sync_tpu.kernels.minn_rtl_triton import minn_rtl_detect

        return minn_rtl_detect(
            jnp.asarray(x), **self._kernel_kw(), interpret=interpret
        )

    @partial(
        jax.jit,
        static_argnums=0,
        static_argnames=("frame_len", "max_frames", "interpret"),
    )
    def _frames_jit(self, planar, *, frame_len, max_frames, interpret):
        from ofdm_sync_tpu.kernels.minn_rtl_triton import minn_rtl_detect
        from ofdm_sync_tpu.ops.extract import extract_frames

        p = self.params
        table = minn_rtl_detect(
            planar[:, None], **self._kernel_kw(), interpret=interpret
        )
        table0 = jax.tree.map(lambda a: a[0], table)
        # window opens at the frame's S0 start: the RTL peak sits at
        # s0 + 6Q (preamble 5Q + pilot CP Q; reference minn_rtl.py:93-103,
        # 943-953), so frame_start = peak + timing_offset - 6Q
        frames, starts, valid = extract_frames(
            planar, table0,
            frame_len=frame_len,
            timing_offset=p.timing_offset - 6 * p.quarter_len,
            max_frames=max_frames,
        )
        return table0, frames, starts, valid

    def detect_frames(
        self, rx, *, frame_len: int, max_frames: int = 4,
        interpret: bool = False,
    ):
        """Receive chain front half: detect (`detect_batch`'s route), then
        the R4 output contract re-emits each aligned frame window on the
        device (circular buffer + timer queue of
        ref/minn_preamble_detector.sv:445-530, re-expressed as
        `ops.extract`'s capacity-bounded batched dynamic-slice).

        rx: (branches, L) complex or (L,).  Windows open at the frame's S0
        start (peak + timing_offset - 6Q, the geometry of reference
        minn_rtl.py:943-953) and span ``frame_len`` samples.  Returns
        ``(result, frames, starts, valid)`` with frames planar
        ``(max_frames, 2*branches, frame_len)`` float32.
        """
        planar = _planar(rx)
        L = planar.shape[-1]
        table0, frames, starts, valid = self._frames_jit(
            planar, frame_len=frame_len, max_frames=max_frames,
            interpret=interpret,
        )
        events = [
            DetectionEvent(
                detected_start=e["peak_index"] + self.params.timing_offset, **e
            )
            for e in events_from_table(table0, L, gate_end_mode="close_excl")
        ]
        result = DetectionResult(events=events, gate_mask=None)
        return (
            result, np.asarray(frames), np.asarray(starts), np.asarray(valid)
        )


# ---------------------------------------------------------------------------
# D4: Park
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParkDetector:
    sys: SystemParams = SYS_30M72

    @property
    def cp_len(self) -> int:
        return self.sys.cp_len // 2  # reference park.py:29

    def metric(self, rx):
        return M.park_metric(_dev(rx), self.sys.n_fft)

    @partial(jax.jit, static_argnums=0)
    def _detect_jit(self, rx):
        ds, Mm, P, E = M.park_metric(rx, self.sys.n_fft)
        peak_rel = jnp.argmax(Mm)
        return ds, Mm, P, E, peak_rel

    def detect(self, rx):
        ds, Mm, P, E, peak_rel = self._detect_jit(_dev(rx))
        det_center = int(ds[int(peak_rel)])
        det_symbol_start = max(det_center - self.sys.n_fft // 2, 0)
        return {
            "ds": ds,
            "M": Mm,
            "P": P,
            "E": E,
            "det_center": det_center,
            "det_symbol_start": det_symbol_start,
            "det_cp_start": max(det_symbol_start - self.cp_len, 0),
        }


# ---------------------------------------------------------------------------
# D5: ZC time-domain matched filter
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ZCTimeDetector:
    sys: SystemParams = SYS_30M72
    params: ZCParams = ZCParams()

    def reference_waveform(self) -> np.ndarray:
        return build_pss_symbol(
            self.sys, self.params.pss_length, self.params.pss_root, include_cp=False
        )

    @partial(jax.jit, static_argnums=0)
    def _detect_jit(self, rx):
        ref = jnp.asarray(self.reference_waveform())
        corr, mag = M.zc_normalized_correlation(rx, ref)
        return corr, mag, jnp.argmax(mag)

    def detect(self, rx):
        corr, mag, peak = self._detect_jit(_dev(rx))
        peak = int(peak)
        ref_len = self.sys.n_fft
        return {
            "corr": corr,
            "corr_mag": mag,
            "peak_index": peak,
            "detected_start": max(peak - ref_len + 1, 0),
        }


# ---------------------------------------------------------------------------
# D6: ZC frequency-domain
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ZCFreqDetector:
    sys: SystemParams = SYS_30M72
    params: ZCParams = ZCParams()
    chunk: int = 512
    #: 'fft' = the reference's chunked per-offset-FFT form (exact parity);
    #: 'sliding' = the sliding-DFT form (each template bin is a windowed
    #: sum of a modulated stream; equal metric to f32 accumulation; see
    #: ops.metrics.zc_freq_metric_sliding)
    form: str = "fft"

    def template(self):
        return (
            centered_subcarrier_indices(self.params.pss_length),
            generate_zadoff_chu(self.params.pss_root, self.params.pss_length),
        )

    @partial(jax.jit, static_argnums=0)
    def _metric_jit(self, rx):
        bins, tmpl = self.template()
        if self.form == "sliding":
            return M.zc_freq_metric_sliding(
                rx, jnp.asarray(tmpl), bins, self.sys.n_fft,
                self.sys.cp_len,
            )
        return M.zc_freq_metric(
            rx, jnp.asarray(tmpl), bins, self.sys.n_fft, self.sys.cp_len,
            chunk=self.chunk,
        )

    def detect(self, rx):
        metric = self._metric_jit(_dev(rx))
        peak = int(jnp.argmax(metric))
        return {"metric": metric, "detected_cp_start": peak}


# ---------------------------------------------------------------------------
# D7: ZC streaming CFAR (FPGA-friendly)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ZCStreamingDetector:
    sys: SystemParams = SYS_30M72
    zc: ZCParams = ZCParams()
    params: ZCStreamingParams = ZCStreamingParams()
    max_events: int = 16
    normalize: bool = True

    def reference_waveform(self) -> np.ndarray:
        return build_pss_symbol(
            self.sys, self.zc.pss_length, self.zc.pss_root, include_cp=False
        )

    @partial(jax.jit, static_argnums=0)
    def _correlate(self, rx):
        """Matched filter (one monolithic FFT) + (optional) per-branch
        normalization."""
        ref = jnp.asarray(self.reference_waveform())
        if self.normalize:
            corr = M.zc_normalized_correlation_per_branch(rx, ref)
        else:
            corr = jnp.sum(M.matched_filter(rx, ref), axis=0)
        return corr, jnp.abs(corr)

    def _cfar(self, corr_mag):
        """CFAR: corr * 2^frac >= running_sum_W(corr) * thresh, plus floor
        (reference zc_v2.py:288-336); returns (local_sum, above, valid)."""
        from ofdm_sync_tpu.ops.windows import running_sum_stream

        local_sum = running_sum_stream(corr_mag, self.params.corr_window)
        n = corr_mag.shape[-1]
        valid = jnp.arange(n) >= self.params.corr_window
        scale = float(1 << self.params.threshold_frac_bits)
        above = (
            valid
            & (corr_mag * scale >= local_sum * float(self.params.threshold_value))
            & (corr_mag >= self.params.min_corr_mag)
        )
        return local_sum, above, valid

    def _events(self, above, corr_mag):
        return extract_gate_events(
            above,
            corr_mag,
            hysteresis=self.params.hysteresis,
            max_events=self.max_events,
            tie="first",
            emit_unclosed=True,
        )

    @partial(jax.jit, static_argnums=0)
    def _detect_jit(self, rx):
        corr, corr_mag = self._correlate(rx)
        local_sum, above, valid = self._cfar(corr_mag)
        table = self._events(above, corr_mag)
        gmask = gate_open_mask(above, self.params.hysteresis)
        return corr, corr_mag, local_sum, above, valid, table, gmask

    def detect(self, rx) -> DetectionResult:
        x = _dev(rx)
        corr, corr_mag, local_sum, above, valid, table, gmask = self._detect_jit(x)
        n = x.shape[-1] + self.sys.n_fft - 1
        ref_len = self.sys.n_fft
        events = [
            DetectionEvent(
                detected_start=max(0, e["peak_index"] - ref_len + 1), **e
            )
            for e in events_from_table(table, n, gate_end_mode="close")
        ]
        res = DetectionResult(events=events, gate_mask=np.asarray(gmask))
        res.state = {  # type: ignore[attr-defined]
            "corr": corr,
            "corr_mag": corr_mag,
            "local_sum": local_sum,
            "above": above,
            "valid": valid,
        }
        return res

    @partial(jax.jit, static_argnums=0)
    def detect_batch(self, iq) -> GateEvents:
        """Event tables of a batch of streams, from IQ (the throughput
        path; per-branch normalization, reference zc_v2.py:486-498).

        iq: (2*branches, batch, L) channel-leading planar float32, rows
        [b0_i, b0_q, ...].  The matched filter is an overlap-save FFT
        convolution in `OLS_BLOCK`-point transforms (cuFFT on a GPU)
        instead of `detect`'s one monolithic transform per stream; the
        CFAR and event extraction are `detect`'s own.  Returns
        `GateEvents` with (batch, max_events) fields over the 'full'
        correlation axis (L + R - 1), equal to `detect` per stream up to
        the FFT factorization's float rounding.
        """
        ref = jnp.asarray(self.reference_waveform(), _C64)
        x = (iq[0::2] + 1j * iq[1::2]).astype(_C64)  # (BR, batch, L)
        x = jnp.swapaxes(x, 0, 1)                      # (batch, BR, L)
        if self.normalize:
            corr = M.zc_normalized_correlation_per_branch(x, ref, OLS_BLOCK)
        else:
            corr = jnp.sum(M.matched_filter(x, ref, OLS_BLOCK), axis=-2)
        corr_mag = jnp.abs(corr)
        _, above, _ = self._cfar(corr_mag)
        return jax.vmap(self._events)(above, corr_mag)

    @staticmethod
    def strongest(result: DetectionResult) -> DetectionEvent | None:
        """Reference selects the strongest event, not the first
        (reference zc_v2.py:567-576)."""
        return result.best_by(lambda e: e.peak_value)


# ---------------------------------------------------------------------------
# D8: combined S&C gate + Minn peak
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CombinedSCMinnDetector:
    sys: SystemParams = SYS_30M72
    smooth_win: int = 16
    sc_gate_threshold: float = 0.6

    @partial(jax.jit, static_argnums=0)
    def _detect_jit(self, rx):
        Mm, P, R = M.minn_metric(rx, self.sys.n_fft)
        M_sc, P_sc, R_sc = M.sc_generic_metric(rx, self.sys.n_fft)
        max_sc = jnp.max(M_sc)
        sc_norm = jnp.where(max_sc > 0, M_sc / max_sc, M_sc)
        gate = sc_norm >= self.sc_gate_threshold
        # seed the gate with the strongest S&C sample if empty
        # (reference combined_sc_min.py:347-351)
        fallback = jnp.zeros_like(gate).at[jnp.argmax(M_sc)].set(True)
        gate = jnp.where(jnp.any(gate), gate, fallback)
        # Minn peak restricted to the S&C gate, trailing-average smoothed,
        # streaming past-only peak: first gate segment's argmax
        # (reference combined_sc_min.py:183-259)
        from ofdm_sync_tpu.ops.windows import trailing_average

        Ms = trailing_average(jnp.maximum(Mm, 0.0), self.smooth_win)
        # emulate the streaming detector: peak within the FIRST gate segment
        idx = jnp.arange(gate.shape[-1], dtype=jnp.int32)
        first_start = jnp.argmax(gate).astype(jnp.int32)
        after = idx >= first_start
        off = jnp.argmax(after & ~gate)  # first False after gate start
        first_end = jnp.where(jnp.any(after & ~gate), off, gate.shape[-1])
        in_first = gate & (idx >= first_start) & (idx < first_end)
        peak = jnp.argmax(jnp.where(in_first, Ms, -jnp.inf)).astype(jnp.int32)
        return Mm, M_sc, sc_norm, gate, Ms, peak

    def detect(self, rx):
        Mm, M_sc, sc_norm, gate, Ms, peak = self._detect_jit(_dev(rx))
        return {
            "M_minn": Mm,
            "M_sc": M_sc,
            "sc_norm": sc_norm,
            "sc_gate_mask": np.asarray(gate),
            "M_smooth": Ms,
            "peak": int(peak),
        }


# ---------------------------------------------------------------------------
# D9: [A][A] grid-tested detector
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AADetector:
    sys: SystemParams = SYS_AA_10M
    params: AADetectorParams = AADetectorParams()
    max_events: int = 8

    @property
    def L(self) -> int:
        return self.params.half_len

    def metric(self, rx) -> M.AAMetricState:
        return self._metric_jit(_dev(rx))

    @partial(jax.jit, static_argnums=0)
    def _metric_jit(self, rx):
        return M.aa_metric(rx, self.L)

    @partial(jax.jit, static_argnums=0)
    def _detect_jit(self, rx):
        state = M.aa_metric(rx, self.L)
        above = state.valid & (state.M >= self.params.threshold)
        track = jnp.abs(state.P) ** 2  # peak on |P|^2, not M
        table = extract_gate_events(
            above,
            track,
            hysteresis=self.params.hysteresis,
            max_events=self.max_events,
            tie="first",
            emit_unclosed=True,
        )
        P_at_peak = state.P[table.peak_idx]
        M_at_peak = state.M[table.peak_idx]
        return state, table, P_at_peak, M_at_peak

    def _assemble_events(self, table, n, p_re, p_im, m_pk) -> DetectionResult:
        """Event list from a gate table + per-slot planar P and M at the
        peak: cfo = angle(P) fs / (2 pi L), frame_start = peak - 2L + 1
        (reference sync_aa.py:533-540).  The one definition shared by
        `detect` and `detect_frames`."""
        L = self.L
        fs = self.sys.sample_rate_hz
        events = []
        for slot, e in zip(
            np.flatnonzero(np.asarray(table.valid)),
            events_from_table(table, n, gate_end_mode="close"),
        ):
            cfo = float(np.arctan2(p_im[slot], p_re[slot])) * fs / (
                2 * np.pi * L
            )
            events.append(
                DetectionEvent(
                    detected_start=e["peak_index"] - 2 * L + 1,
                    cfo_hz=cfo,
                    metric_at_peak=float(m_pk[slot]),
                    **e,
                )
            )
        return DetectionResult(events=events)

    def detect(self, rx) -> tuple[M.AAMetricState, DetectionResult]:
        x = _dev(rx)
        state, table, P_at_peak, M_at_peak = self._detect_jit(x)
        P_at_peak = np.asarray(P_at_peak)
        return state, self._assemble_events(
            table, x.shape[-1], P_at_peak.real, P_at_peak.imag,
            np.asarray(M_at_peak),
        )

    def detect_frames(
        self, rx, *, frame_len: int, max_frames: int = 4
    ):
        """R4 output contract: detect AND re-emit the aligned frame windows
        on device (reference ref/minn_preamble_detector.sv:445-530 -- the
        circular-buffer + timer-queue re-emission; here a capacity-bounded
        batched dynamic-slice over the device-resident stream,
        `ops.extract`).

        Frame windows open at ``peak - 2L + 1`` (the AA frame start,
        reference sync_aa.py:540 / docs/aa_preamble_sync_design.md §9) and
        span ``frame_len`` samples.  Returns ``(result, frames, starts,
        valid)`` with frames planar ``(max_frames, 2*BR, frame_len)``
        float32.
        """
        from ofdm_sync_tpu.ops.extract import extract_frames

        x = _dev(rx)
        n = x.shape[-1]
        _, table, P_at_peak, M_at_peak = self._detect_jit(x)
        frames, starts, valid = extract_frames(
            _planar(x), table,
            frame_len=frame_len,
            timing_offset=-(2 * self.L - 1),
            max_frames=max_frames,
        )
        P_at_peak = np.asarray(P_at_peak)
        result = self._assemble_events(
            table, n, P_at_peak.real, P_at_peak.imag, np.asarray(M_at_peak)
        )
        return result, np.asarray(frames), np.asarray(starts), np.asarray(
            valid
        )

    @staticmethod
    def best(result: DetectionResult) -> DetectionEvent | None:
        """Strongest event by metric (reference sync_aa.py:742-743)."""
        return result.best_by(lambda e: e.metric_at_peak)
