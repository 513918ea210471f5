"""Unified CLI: ``python -m ofdm_sync_tpu <command> [options]``.

The reference exposes its experiments as one flat script per detector, each
with a bare ``main()`` (reference sc.py:350, minn.py:635, minn_rtl.py:1467,
park.py:329, zc.py:261, zc_freq.py:272, zc_v2.py:765, combined_sc_min.py:558,
sync_aa.py:1075, ofdm_cp_fft_demo.py).  This dispatcher is their packaged
equivalent, plus framework-only commands (bench, native oracle, profiling).
"""

from __future__ import annotations

import argparse
import importlib
import sys

_PIPELINES = {
    "sc": "Schmidl-Cox end-to-end simulation (reference sc.py)",
    "minn": "standard Minn detector simulation + sweeps (reference minn.py)",
    "minn_rtl": "RTL-style adjacent-quarter Minn (reference minn_rtl.py)",
    "park": "Park detector simulation (reference park.py)",
    "zc": "Zadoff-Chu time-domain matched filter (reference zc.py)",
    "zc_freq": "Zadoff-Chu frequency-domain search (reference zc_freq.py)",
    "zc_v2": "streaming/CFAR Zadoff-Chu detector (reference zc_v2.py)",
    "combined_sc_minn": "S&C gate + Minn peak (reference combined_sc_min.py)",
    "aa": "[A][A] detector grid test (reference sync_aa.py)",
    "cp_fft_demo": "CP/FFT STO pedagogy demo (reference ofdm_cp_fft_demo.py)",
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ofdm_sync_tpu",
        description="OFDM preamble-synchronization framework (JAX)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name, help_text in _PIPELINES.items():
        sub.add_parser(name, help=help_text)
    sub.add_parser("bench", help="headline GPU benchmark (one JSON line)")
    sub.add_parser(
        "list", help="list detector families and system parameter sets"
    )
    p_rx = sub.add_parser(
        "fused_rx",
        help="receive chain on the device: detect -> frame re-emission -> "
             "CFO -> LS EQ -> EVM",
    )
    p_rx.add_argument("--family", default="aa", choices=("aa", "minn_rtl"),
                      help="aa: 10 MHz [A][A] system; minn_rtl: the "
                      "flagship Minn-RTL 30.72 MHz family")
    p_rx.add_argument("--snr", type=float, default=None)
    p_rx.add_argument("--channel", default=None,
                      help="cir1 / cir2 / omit for AWGN")
    p_rx.add_argument("--cfo", type=float, default=None)
    p_rx.add_argument("--preamble-len", type=int, default=1024)
    p_rx.add_argument("--num-frames", type=int, default=1)
    p_wave = sub.add_parser(
        "waveform",
        help="plot preamble / QPSK symbol / frame views "
             "(reference ref/ofdm.py:286-331 CLI)",
    )
    p_wave.add_argument(
        "kind",
        choices=["preamble", "qpsk", "frame", "aa_preamble"],
        help="waveform to render",
    )
    p_wave.add_argument("--out", default="plots/waveforms",
                        help="output directory")
    p_wave.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if args.command == "bench":
        import runpy
        from pathlib import Path

        bench = Path(__file__).resolve().parents[1] / "bench.py"
        runpy.run_path(str(bench), run_name="__main__")
        return 0
    if args.command == "list":
        from ofdm_sync_tpu.models import detectors

        for name in _PIPELINES:
            print(f"{name:18s} {_PIPELINES[name]}")
        print()
        for cls in (
            detectors.SCDetector, detectors.MinnDetector,
            detectors.MinnRTLDetector, detectors.ParkDetector,
            detectors.ZCTimeDetector, detectors.ZCFreqDetector,
            detectors.ZCStreamingDetector, detectors.CombinedSCMinnDetector,
            detectors.AADetector,
        ):
            print(f"model: {cls.__name__}")
        return 0

    if args.command == "waveform":
        return _waveform_cmd(args)

    if args.command == "fused_rx":
        from ofdm_sync_tpu.pipelines.fused_rx import (
            run_fused_rx, run_fused_rx_minn_rtl,
        )

        if args.family == "minn_rtl":
            run_fused_rx_minn_rtl(
                snr_db=args.snr if args.snr is not None else 0.0,
                channel_name=args.channel,
                cfo_hz=args.cfo if args.cfo is not None else 1000.0,
            )
        else:
            run_fused_rx(
                snr_db=args.snr if args.snr is not None else 10.0,
                channel_name=args.channel,
                cfo_hz=args.cfo if args.cfo is not None else 500.0,
                preamble_length=args.preamble_len,
                num_frames=args.num_frames,
            )
        return 0

    mod = importlib.import_module(f"ofdm_sync_tpu.pipelines.{args.command}")
    mod.main()
    return 0


def _waveform_cmd(args) -> int:
    """Render waveform diagnostics (the packaged twin of the reference's
    ref/ofdm.py argparse demo)."""
    from pathlib import Path

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from ofdm_sync_tpu.ops import waveforms as W
    from ofdm_sync_tpu.params import SYS_30M72, SYS_AA_10M

    rng = np.random.default_rng(args.seed)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.kind == "preamble":
        sig, _ = W.build_hermitian_minn_preamble(SYS_30M72, rng)
        title = "Minn [A A -A -A] preamble (Hermitian-symmetric values)"
    elif args.kind == "qpsk":
        sig, _ = W.build_random_qpsk_symbol(rng, SYS_30M72)
        title = "Random QPSK OFDM symbol"
    elif args.kind == "aa_preamble":
        sig, _, papr = W.build_aa_preamble(1024, SYS_AA_10M)
        title = f"[A][A] preamble (PAPR {papr:.2f} dB)"
    else:  # frame
        pre, _ = W.build_hermitian_minn_preamble(SYS_30M72, rng)
        pilot, _ = W.build_random_qpsk_symbol(rng, SYS_30M72)
        data, _ = W.build_random_qpsk_symbol(rng, SYS_30M72)
        sig = W.assemble_frame(pre, pilot, data, pre_pad=SYS_30M72.tx_pre_pad)
        title = "Full frame: [guard | preamble | pilot | data]"
    sig = np.asarray(sig)
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(11, 6))
    a1.plot(sig.real, linewidth=0.6, label="I")
    a1.plot(sig.imag, linewidth=0.6, label="Q")
    a1.set_title(title)
    a1.legend()
    a1.grid(True, alpha=0.4)
    a2.plot(np.abs(sig), linewidth=0.6)
    a2.set_title("Magnitude")
    a2.set_xlabel("Sample")
    a2.grid(True, alpha=0.4)
    fig.tight_layout()
    path = out / f"{args.kind}.png"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"{title}: {sig.size} samples -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
