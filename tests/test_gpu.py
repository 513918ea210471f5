"""Tests that need the GPU: the fused kernel compiled by Triton, against
the XLA datapath on the same card.  They skip on the CPU (the `gpu`
fixture decides at run time).  Run on the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:cacheprovider``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_sync_tpu.conformance.device_checks import minn_stimulus, table_diff
from ofdm_sync_tpu.kernels import minn_rtl_triton as mt

pytestmark = pytest.mark.gpu

KW = dict(quarter_len=512, smooth_shift=3,
          threshold_value=int(0.10 * (1 << 15)), threshold_frac_bits=15,
          hysteresis=2, max_events=8)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int16])
def test_compiled_kernel_matches_xla(gpu, dtype):
    x = minn_stimulus(64, 1 << 16, 512, every=2)
    ref = mt.minn_rtl_detect_xla(x, **KW)
    out = jax.jit(lambda v: mt.minn_rtl_detect_triton(v, **KW))(
        x.astype(dtype)
    )
    assert table_diff(ref, out, name="compiled") == []
    assert int(np.asarray(ref.count).sum()) >= 32


def test_route_is_the_kernel_on_the_gpu(gpu):
    assert mt.use_kernel(512, 3, 2)
    assert not mt.use_kernel(48, 3, 2)


def test_sharded_over_local_cards(gpu):
    from ofdm_sync_tpu.conformance.device_checks import (
        sharded_detection_errors,
    )

    devices = jax.devices()
    if len(devices) < 2:
        pytest.skip("needs two or more cards")
    n = 1 << (len(devices).bit_length() - 1)
    x = minn_stimulus(8 * n, n * (1 << 14), 512)
    errs = sharded_detection_errors(x, devices[:n], KW)
    assert all(not v for v in errs.values()), errs
