"""The row gather gather_rows (plain version on CPU tensors) against the
JAX package's gather_padded, the function the Pallas probe `pg` of
tools/exp_gather2.py computes: row counts that are no multiple of the
rows a block of the kernel covers (csrc/gather_rows.cu: 256 threads, one
16-byte piece each), indices -1 and N, both table and index types.
chip_smoke.py runs the same kind of cases on the kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from umeregrobust_tpu.ops.neighbors import gather_padded as jax_gather
from umeregrobust_tpu_torch.ops import cuda_gather


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("extra", [-1, 1, 5])
@pytest.mark.parametrize("C,dtype", [(32, "float32"), (32, "bfloat16"),
                                     (128, "float32"), (7, "float32")])
def test_gather_rows_ragged_rows_and_edge_indices_match_jax(C, dtype, extra,
                                                            idx_dtype):
    esz = 2 if dtype == "bfloat16" else 4
    per_block = max(1, 256 * 16 // (C * esz))
    M, N = 3 * per_block + extra, 300
    rng = np.random.default_rng(M * C)
    table = rng.standard_normal((N, C)).astype(np.float32)
    idx = rng.integers(-1, N + 1, M)
    idx[:3] = (-1, N, N - 1)
    tt = t(table).to(getattr(torch, dtype))
    got = cuda_gather.gather_rows(tt, t(idx).to(idx_dtype))
    want = np.asarray(jax_gather(jnp.asarray(table).astype(getattr(jnp, dtype)),
                                 jnp.asarray(idx, jnp.int32)
                                 ).astype(jnp.float32))
    assert got.dtype == tt.dtype and got.shape == (M, C)
    np.testing.assert_array_equal(n(got.float()), want)
    np.testing.assert_array_equal(want[(idx < 0) | (idx >= N)], 0)
    np.testing.assert_array_equal(want[2], n(tt[N - 1].float()))
