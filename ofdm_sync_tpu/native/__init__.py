"""ctypes bindings for the native (C++) streaming detector runtime.

The reference's native components are its four SystemVerilog RTL modules;
this package holds their C++ bit-accurate integer models (see
native/src/minn_rtl.cc), used as the independent fixed-point oracle for the
float kernels -- the role the Verilator co-simulation plays in the
reference (ref/test_minn_preamble_detector.py:455-489) -- and as a host-side
streaming detector.

The shared library is built on demand with g++ (no pip/pybind dependency)
and cached next to the sources; rebuilds trigger automatically when the
source is newer than the binary.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "src" / "minn_rtl.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "native" / "build"
_LIB_PATH = _BUILD_DIR / "libminn_rtl.so"

_ABI_VERSION = 2


class NativeBuildError(RuntimeError):
    pass


def _build() -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a per-process temp name and atomically rename: concurrent
    # test processes may race to (re)build
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-o", str(tmp), str(_SRC),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"native build failed: {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, _LIB_PATH)


_lib_cache: ctypes.CDLL | None = None


class _Params(ctypes.Structure):
    _fields_ = [
        ("quarter_len", ctypes.c_int32),
        ("smooth_shift", ctypes.c_int32),
        ("frac_bits", ctypes.c_int32),
        ("threshold_value", ctypes.c_int64),
        ("hysteresis", ctypes.c_int32),
        ("emit_unclosed", ctypes.c_int32),
        ("timing_offset", ctypes.c_int32),
    ]


class _AAParams(ctypes.Structure):
    _fields_ = [
        ("half_len", ctypes.c_int32),
        ("threshold_q", ctypes.c_int64),
        ("frac_bits", ctypes.c_int32),
        ("hysteresis", ctypes.c_int32),
        ("emit_unclosed", ctypes.c_int32),
    ]


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native runtime library."""
    global _lib_cache
    if _lib_cache is not None:
        return _lib_cache
    # '<=' so equal mtimes (coarse filesystems, archive extraction, fresh
    # clones) rebuild rather than silently trusting a possibly-stale oracle
    stale = (
        not _LIB_PATH.exists()
        or _LIB_PATH.stat().st_mtime <= _SRC.stat().st_mtime
    )
    if stale:
        _build()
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.minn_rtl_abi_version.restype = ctypes.c_int32
    if lib.minn_rtl_abi_version() != _ABI_VERSION:
        _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    def opt(ptr_type):
        # nullable array arguments
        class _Opt:
            @classmethod
            def from_param(cls, obj):
                if obj is None:
                    return None
                return ptr_type.from_param(obj)

        return _Opt

    lib.minn_rtl_detect_i16.restype = ctypes.c_int64
    lib.minn_rtl_detect_i16.argtypes = [
        i16p, ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(_Params),
        i32p, i32p, i32p, f64p, u8p, ctypes.c_int32,
        opt(i64p), opt(i64p), opt(i64p), opt(u8p),
    ]
    lib.aa_detect_i16.restype = ctypes.c_int64
    lib.aa_detect_i16.argtypes = [
        i16p, ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(_AAParams),
        i32p, i32p, i32p, f64p, f64p, f64p, u8p, ctypes.c_int32,
        opt(i64p), opt(i64p), opt(i64p), opt(u8p),
    ]
    _lib_cache = lib
    return lib


@dataclass
class NativeAADetection:
    """[A][A] event table + optional integer traces (C++ fixed point)."""

    count: int
    total: int
    gate_start: np.ndarray
    gate_close: np.ndarray
    peak_idx: np.ndarray
    peak_value: np.ndarray   # |P|^2 at peak
    p_at_peak: np.ndarray    # complex, for CFO = angle(P) fs / (2 pi L)
    closed: np.ndarray
    P_re: np.ndarray | None = None
    P_im: np.ndarray | None = None
    R: np.ndarray | None = None
    above: np.ndarray | None = None

    @property
    def overflow(self) -> bool:
        return self.total > self.count


def aa_detect_native(
    iq: np.ndarray,
    *,
    half_len: int = 512,
    threshold: float = 0.15,
    threshold_frac_bits: int = 15,
    hysteresis: int = 128,
    emit_unclosed: bool = True,
    max_events: int = 8,
    return_traces: bool = False,
) -> NativeAADetection:
    """Run the C++ fixed-point [A][A] detector on planar int16 IQ.

    iq: (branches, 2, L) int16.  Implements the FPGA design doc's pipeline
    (reference docs/aa_preamble_sync_design.md sections 5-9) in exact integer
    arithmetic with a 128-bit division-free M >= theta compare.
    """
    lib = load_library()
    iq = np.ascontiguousarray(iq, dtype=np.int16)
    if iq.ndim == 2:
        iq = iq[None]
    branches, planes, n = iq.shape
    if planes != 2:
        raise ValueError("expected planar (branches, 2, L) IQ")
    p = _AAParams(
        half_len=half_len,
        threshold_q=int(round(threshold * (1 << threshold_frac_bits))),
        frac_bits=threshold_frac_bits,
        hysteresis=hysteresis,
        emit_unclosed=int(emit_unclosed),
    )
    ev_start = np.zeros(max_events, np.int32)
    ev_close = np.zeros(max_events, np.int32)
    ev_peak = np.zeros(max_events, np.int32)
    ev_val = np.zeros(max_events, np.float64)
    ev_pre = np.zeros(max_events, np.float64)
    ev_pim = np.zeros(max_events, np.float64)
    ev_closed = np.zeros(max_events, np.uint8)
    if return_traces:
        tp = np.zeros(n, np.int64)
        tq = np.zeros(n, np.int64)
        tr = np.zeros(n, np.int64)
        ta = np.zeros(n, np.uint8)
    else:
        tp = tq = tr = ta = None
    total = lib.aa_detect_i16(
        iq, n, branches, ctypes.byref(p),
        ev_start, ev_close, ev_peak, ev_val, ev_pre, ev_pim, ev_closed,
        max_events, tp, tq, tr, ta,
    )
    count = int(min(total, max_events))
    return NativeAADetection(
        count=count,
        total=int(total),
        gate_start=ev_start[:count],
        gate_close=ev_close[:count],
        peak_idx=ev_peak[:count],
        peak_value=ev_val[:count],
        p_at_peak=ev_pre[:count] + 1j * ev_pim[:count],
        closed=ev_closed[:count].astype(bool),
        P_re=tp,
        P_im=tq,
        R=tr,
        above=ta,
    )


@dataclass
class NativeDetection:
    """Event table + optional integer traces from the native detector."""

    count: int           # events stored (clipped to capacity)
    total: int           # total gates seen (overflow if > count)
    gate_start: np.ndarray
    gate_close: np.ndarray
    peak_idx: np.ndarray
    peak_value: np.ndarray
    closed: np.ndarray
    corr_total: np.ndarray | None = None
    energy_total: np.ndarray | None = None
    smooth: np.ndarray | None = None
    above: np.ndarray | None = None

    @property
    def overflow(self) -> bool:
        return self.total > self.count


def minn_rtl_detect_native(
    iq: np.ndarray,
    *,
    quarter_len: int,
    smooth_shift: int = 3,
    threshold_value: int = 3276,
    threshold_frac_bits: int = 15,
    hysteresis: int = 2,
    emit_unclosed: bool = False,
    timing_offset: int = 0,
    max_events: int = 8,
    return_traces: bool = False,
) -> NativeDetection:
    """Run the C++ integer detector on planar int16 IQ.

    iq: (branches, 2, L) int16 (int12-range values, as produced by
    `ops.channel.quantize_int`).  Defaults mirror the RTL parameters
    (reference minn_rtl.py:829-844).
    """
    lib = load_library()
    iq = np.ascontiguousarray(iq, dtype=np.int16)
    if iq.ndim == 2:  # (2, L) single branch
        iq = iq[None]
    branches, planes, n = iq.shape
    if planes != 2:
        raise ValueError("expected planar (branches, 2, L) IQ")
    p = _Params(
        quarter_len=quarter_len,
        smooth_shift=smooth_shift,
        frac_bits=threshold_frac_bits,
        threshold_value=threshold_value,
        hysteresis=hysteresis,
        emit_unclosed=int(emit_unclosed),
        timing_offset=timing_offset,
    )
    ev_start = np.zeros(max_events, np.int32)
    ev_close = np.zeros(max_events, np.int32)
    ev_peak = np.zeros(max_events, np.int32)
    ev_val = np.zeros(max_events, np.float64)
    ev_closed = np.zeros(max_events, np.uint8)
    if return_traces:
        tc = np.zeros(n, np.int64)
        te = np.zeros(n, np.int64)
        ts = np.zeros(n, np.int64)
        ta = np.zeros(n, np.uint8)
    else:
        tc = te = ts = ta = None
    total = lib.minn_rtl_detect_i16(
        iq, n, branches, ctypes.byref(p),
        ev_start, ev_close, ev_peak, ev_val, ev_closed, max_events,
        tc, te, ts, ta,
    )
    count = int(min(total, max_events))
    return NativeDetection(
        count=count,
        total=int(total),
        gate_start=ev_start[:count],
        gate_close=ev_close[:count],
        peak_idx=ev_peak[:count],
        peak_value=ev_val[:count],
        closed=ev_closed[:count].astype(bool),
        corr_total=tc,
        energy_total=te,
        smooth=ts,
        above=ta,
    )
