"""Multi-host bootstrap: one call per process, then the sharded detectors
in `parallel.shard` run unchanged over the global device mesh.

The reference is single-process NumPy (SURVEY section 2.5); this is the
framework's scale-out layer.  The cards of one host reach each other all
to all at one rate (NVLink), so within a host the mesh follows the
algorithm alone.  Across hosts, keep the ``seq`` axis inside a host -- its
halo exchanges (`jax.lax.ppermute` of a few thousand samples per boundary
per step) and the event-merge collectives are latency-sensitive -- and put
the ``data`` axis across hosts, where independent streams need no
communication at all.  `make_global_stream_mesh` does exactly that by
keeping ``seq`` minor (devices within a host are adjacent in
`jax.devices()` order).

Typical multi-host launch (one process per host)::

    from ofdm_sync_tpu.parallel import distributed, shard
    distributed.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = distributed.make_global_stream_mesh(n_seq=4)
    table = shard.sharded_minn_rtl_detect_fused(iq, mesh, ...)

Single-process use (tests, one chip, the CPU virtual-device mesh) needs no
`initialize()` -- `make_global_stream_mesh` works on whatever devices exist.
"""

from __future__ import annotations

import jax

from ofdm_sync_tpu.parallel.shard import make_stream_mesh


_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the multi-process JAX runtime (idempotent).

    Pass the coordinator's ``host:port``, the process count, and this
    process's rank (`jax.distributed.initialize` semantics); only a cluster
    environment that JAX detects by itself may omit them.  Must be
    called BEFORE anything touches the XLA backend (jax.devices() etc.).
    After this returns, `jax.devices()` is the GLOBAL device list and every
    process must execute the same sharded program (SPMD).
    """
    global _initialized
    if _initialized:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
        _initialized = True
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            _initialized = True
            return
        if not kwargs:  # env-driven single-process runs: nothing to join
            return
        raise


def make_global_stream_mesh(n_data: int | None = None, n_seq: int | None = None):
    """(data, seq) mesh over ALL processes' devices.

    Defaults: ``seq`` spans the devices of one host (adjacent in device
    order) and ``data`` spans hosts -- halo exchange stays inside a host,
    the embarrassingly-parallel stream axis crosses hosts.  Pass explicit sizes to
    override (their product must equal the global device count).
    """
    total = len(jax.devices())
    per_host = jax.local_device_count()
    if n_data is None and n_seq is None:
        n_seq = per_host
        n_data = total // per_host
    elif n_seq is None:
        n_seq = total // n_data
    elif n_data is None:
        n_data = total // n_seq
    return make_stream_mesh(n_data=n_data, n_seq=n_seq)
