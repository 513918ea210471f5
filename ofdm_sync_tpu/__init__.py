"""ofdm_sync_tpu: OFDM preamble-synchronization framework on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
`ofdm-sync-math` reference repo: five preamble-detector families
(Schmidl-Cox, Minn, Minn-RTL adjacent-quarter, Park, Zadoff-Chu
time/frequency/streaming-CFAR, plus the [A][A] grid-tested detector),
multipath+AWGN channel emulation from measured CIRs, CFO estimation,
LS channel estimation/equalization/EVM -- all as streaming array programs
over device-resident IQ, sharded across device meshes.
"""

from ofdm_sync_tpu.params import (
    SystemParams,
    SYS_30M72,
    SYS_AA_10M,
    SCDetectorParams,
    MinnDetectorParams,
    MinnRTLParams,
    ZCParams,
    ZCStreamingParams,
    AADetectorParams,
)

__version__ = "0.1.0"
