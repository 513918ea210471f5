"""True 2-process `jax.distributed` test (SURVEY.md multi-host recipe).

Spawns two worker processes with a localhost coordinator and 4 virtual CPU
devices each (global mesh: 8 devices over 2 processes), runs
`distributed.initialize` + `make_global_stream_mesh` +
`sharded_minn_rtl_detect_fused` on a globally-sharded stream array, and
asserts each process's local event tables equal the single-process XLA
reference.  This executes the actual multi-process code path
(`parallel/distributed.py`) rather than reading it.

The worker re-invokes this file with ``--worker <rank> <port>``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

Q = 64
KW = dict(
    quarter_len=Q, smooth_shift=3, threshold_value=3276,
    threshold_frac_bits=15, hysteresis=2,
)
BATCH, L = 4, 1 << 13  # 2 streams per process, 4 seq shards of 2048


def _stimulus():
    import numpy as np

    rng = np.random.default_rng(11)
    x = (0.25 * rng.standard_normal((4, BATCH, L))).astype(np.float32)
    A = rng.standard_normal(Q) + 1j * rng.standard_normal(Q)
    pre = np.concatenate([-A, A, A, -A, -A])
    pre /= np.sqrt(np.mean(np.abs(pre) ** 2))
    Lb = L // 4
    for b, p in ((0, 500), (1, Lb - 2 * Q), (2, 2 * Lb - Q // 2), (3, 700)):
        x[0, b, p : p + 5 * Q] += 3 * pre.real.astype(np.float32)
        x[1, b, p : p + 5 * Q] += 3 * pre.imag.astype(np.float32)
    return x


def _worker(rank: int, port: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ofdm_sync_tpu.parallel import distributed
    from ofdm_sync_tpu.parallel.shard import sharded_minn_rtl_detect_fused
    from ofdm_sync_tpu.kernels.streaming import minn_rtl_detect_planar

    distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=rank,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())

    # data axis across processes, seq axis within: the documented layout
    mesh = distributed.make_global_stream_mesh(n_data=2, n_seq=4)

    x = _stimulus()
    sharding = NamedSharding(mesh, P(None, "data", "seq"))
    garr = jax.make_array_from_callback(
        x.shape, sharding, lambda idx: x[idx]
    )

    fn = jax.jit(
        lambda v: sharded_minn_rtl_detect_fused(
            v, mesh, **KW, interpret=True,
        ),
        out_shardings=None,
    )
    table = fn(garr)

    # single-process reference on the full stimulus (pure local compute)
    def one(stream):
        _, t = minn_rtl_detect_planar(stream.reshape(2, 2, L), **KW)
        return t

    ref = jax.jit(jax.vmap(one, in_axes=1))(jnp.asarray(x))

    # each process checks the streams it holds (batch is data-sharded)
    for field in ("count", "gate_start", "gate_close", "peak_idx", "valid"):
        got = getattr(table, field)
        want = np.asarray(getattr(ref, field))
        for shard in got.addressable_shards:
            sl = shard.index[0]  # batch-dim slice of this shard
            np.testing.assert_array_equal(
                np.asarray(shard.data), want[sl], err_msg=field
            )
    print(f"worker {rank}: OK", flush=True)


@pytest.mark.slow
def test_two_process_distributed_detect():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    )
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONUNBUFFERED"] = "1"

    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(rank), str(port)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("2-process run timed out:\n" + "\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            if "UNIMPLEMENTED" in out or "distributed" in out.lower() and (
                "not supported" in out.lower()
            ):
                pytest.skip(f"multi-process runtime unavailable:\n{out[-800:]}")
            pytest.fail(f"worker {rank} failed (rc={p.returncode}):\n{out}")
        assert f"worker {rank}: OK" in out, out


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "--worker":
        sys.path.insert(0, str(REPO))
        _worker(int(sys.argv[2]), int(sys.argv[3]))
    else:
        test_two_process_distributed_detect()
        print("2-process test OK")
