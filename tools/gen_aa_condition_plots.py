#!/usr/bin/env python
"""Generate the per-condition [A][A] detail artifact set.

The reference commits per-cell PNGs under plots/sync_aa/{awgn,cir1,cir2}/
(reference sync_aa.py:746-806: generated by the grid with plot_samples=True,
gated to FS=1.0 and the default 1024-sample preamble, i.e. L=512).  This
tool runs exactly those 15 grid cells (5 SNRs x 3 channels) through
`pipelines.aa.run_single_test(plot=True)` so the committed tree carries the
same per-condition observability set (V8 parity).

Run from the repo root:  python tools/gen_aa_condition_plots.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import matplotlib

matplotlib.use("Agg")

from ofdm_sync_tpu.pipelines.aa import PLOTS_DIR, run_single_test


def main() -> None:
    for channel in (None, "cir1", "cir2"):
        channel_str = channel if channel else "awgn"
        for snr_db in (-5, 0, 5, 10, 15):
            r = run_single_test(
                snr_db=snr_db,
                channel_name=channel,
                full_scale_ratio=1.0,
                preamble_length=1024,
                cfo_hz=500.0,
                seed=42,
                plot=True,
                plot_dir=PLOTS_DIR / channel_str,
            )
            status = "OK " if r.detected else "MISS"
            print(
                f"{channel_str:6s} SNR={snr_db:+3.0f}dB -> {status} "
                f"timing_err={r.timing_error:+4d} "
                f"cfo_err={r.cfo_error_hz:+7.1f}Hz"
            )


if __name__ == "__main__":
    main()
