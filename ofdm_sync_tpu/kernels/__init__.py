"""Hot-path kernels and planar datapaths.

  * `streaming` -- planar-float XLA datapaths (portable, shard_map-friendly)
  * `minn_rtl_triton` -- the fused Minn-RTL batch detector for the GPU
    (Pallas through Triton), with the route choice between it and XLA
  * `streaming_chunked` -- carried-state chunk-by-chunk detection
  * `blocked` -- compile-fast two-level prefix ops for very long axes

Submodule attributes are re-exported lazily (`ops.windows` depends on
`kernels.blocked`, so eager re-export here would be a circular import).
"""

_STREAMING = (
    "aa_metric_planar",
    "from_planar",
    "minn_rtl_detect_planar",
    "minn_rtl_metric_planar",
    "to_planar",
)
_TRITON = (
    "minn_rtl_detect",
    "minn_rtl_detect_triton",
    "minn_rtl_detect_xla",
)
_SUBMODULES = ("blocked", "streaming", "minn_rtl_triton", "streaming_chunked")

__all__ = list(_STREAMING + _TRITON) + list(_SUBMODULES)


def __getattr__(name: str):
    import importlib

    if name in _STREAMING:
        return getattr(
            importlib.import_module("ofdm_sync_tpu.kernels.streaming"), name
        )
    if name in _TRITON:
        return getattr(
            importlib.import_module("ofdm_sync_tpu.kernels.minn_rtl_triton"),
            name,
        )
    if name in _SUBMODULES:
        return importlib.import_module(f"ofdm_sync_tpu.kernels.{name}")
    raise AttributeError(name)
