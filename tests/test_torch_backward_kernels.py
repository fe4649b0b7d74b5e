"""Host-side pieces of the two backward kernels' designs (CPU, small
sizes): the row segments that gather_rows_backward's counting sort
builds (csrc/gather_rows.cu) held against the stable sort + searchsorted
the wrapper used before, the placement-then-sort order of that design
held to the stable order, the backward's plain version against JAX's
autodiff of the gather, and sparse_conv_wgrad's plan (kernel, segments,
scratch, grid) and its entry-segment sum order held against the plain
version and JAX. chip_smoke.py phase 5j runs the kernels themselves."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from umeregrobust_tpu.ops.neighbors import gather_padded as jax_gather
from umeregrobust_tpu.ops.sparse import sparse_conv as jax_sparse_conv
from umeregrobust_tpu_torch.ops import _build, cuda_conv, cuda_gather

PKG = Path(__file__).resolve().parents[1] / "umeregrobust_tpu_torch"


def _constants(source):
    src = (PKG / "csrc" / source).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _indices(case, rng):
    """(idx, n_rows) of a named case, made with numpy from the seed."""
    if case == "random_with_minus_one":
        return rng.integers(-1, 300, 5000), 300
    if case == "indices_past_n":
        return rng.integers(-3, 80, 2000), 50
    if case == "one_row":
        return rng.integers(-1, 1, 700), 1
    if case == "nothing_valid":
        return np.full(64, -1), 10
    if case == "hot_row":  # one row hit 900 times, past the register sort
        idx = rng.integers(-1, 2000, 6000)
        idx[rng.permutation(6000)[:900]] = 17
        return idx, 2000
    if case == "empty":
        return np.zeros(0, np.int64), 4
    raise ValueError(case)


CASES = ["random_with_minus_one", "indices_past_n", "one_row",
         "nothing_valid", "hot_row", "empty"]


def _sorted_form(idx, n_rows):
    """The first port's form: a stable sort of the keys (invalid last)
    and searchsorted of each row's start."""
    key = torch.where((idx >= 0) & (idx < n_rows), idx,
                      torch.full_like(idx, n_rows))
    skey, perm = torch.sort(key, stable=True)
    starts = torch.searchsorted(skey, torch.arange(n_rows + 1))
    return starts, perm[: int(starts[-1])]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", CASES)
def test_row_segments_plain_equals_stable_sort_and_searchsorted(case, dtype):
    # exact: integer results
    idx, n_rows = _indices(case, np.random.default_rng(len(case)))
    it = t(idx).to(dtype)
    starts, pos = cuda_gather.row_segments(it, n_rows)  # CPU: plain
    want_starts, want_pos = _sorted_form(it.to(torch.int64), n_rows)
    assert starts.dtype == pos.dtype == torch.int32
    np.testing.assert_array_equal(n(starts), n(want_starts))
    np.testing.assert_array_equal(n(pos), n(want_pos))
    valid = (idx >= 0) & (idx < n_rows)
    assert int(starts[-1]) == int(valid.sum()) == pos.shape[0]


@pytest.mark.parametrize("case", CASES)
def test_placing_in_any_block_order_then_sorting_each_segment_is_stable(
        case):
    # the kernel's order of work, emulated: counts, starts from their
    # scan, positions placed through per-row cursors in an arbitrary order
    # (blocks run in no order), then each segment sorted; exact
    rng = np.random.default_rng(7)
    idx, n_rows = _indices(case, rng)
    valid = (idx >= 0) & (idx < n_rows)
    counts = np.bincount(idx[valid], minlength=n_rows)
    starts = np.concatenate([[0], np.cumsum(counts)])
    cursor = np.zeros(n_rows, np.int64)
    pos = np.full(int(valid.sum()), -1)
    for i in rng.permutation(len(idx)):
        if valid[i]:
            r = idx[i]
            pos[starts[r] + cursor[r]] = i
            cursor[r] += 1
    for r in range(n_rows):
        pos[starts[r]: starts[r + 1]].sort()
    want_starts, want_pos = cuda_gather.row_segments_plain(t(idx), n_rows)
    np.testing.assert_array_equal(starts, n(want_starts))
    np.testing.assert_array_equal(pos, n(want_pos))


def test_segment_scratch_mirrors_the_kernel_layout():
    # counts and starts N + 1 each, a sum per scan tile, positions and
    # their merge twin: the C entry's offsets
    c = _constants("gather_rows.cu")
    assert cuda_gather._SCAN_TILE == c["kSegThreads"] * c["kScanItems"]
    for m, n_rows in ((0, 1), (3_072_000, 131_072), (10, 4095), (10, 4096)):
        tiles = -(-(n_rows + 1) // cuda_gather._SCAN_TILE)
        assert cuda_gather.segment_scratch(m, n_rows) == \
            2 * (n_rows + 1) + tiles + 2 * m


@pytest.mark.parametrize("case", ["random_with_minus_one", "hot_row",
                                  "indices_past_n", "nothing_valid"])
def test_gather_rows_backward_matches_jax_grad(case):
    # the CPU path is the plain version (index_add_ in ascending
    # position); against JAX's autodiff of gather_padded: 1e-5 x max
    # (another summation order), and exact where a row has one position
    rng = np.random.default_rng(3)
    idx, n_rows = _indices(case, rng)
    C = 5
    x = rng.normal(size=(n_rows, C)).astype(np.float32)
    g = rng.normal(size=(len(idx), C)).astype(np.float32)
    jidx = np.where((idx >= 0) & (idx < n_rows), idx, -1)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jax_gather(a, jnp.asarray(jidx)) * jnp.asarray(g)))(jnp.asarray(x)))
    got = n(cuda_gather.gather_rows_backward(t(g), t(idx), n_rows))
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= 1e-5 * scale
    once = np.bincount(jidx[jidx >= 0], minlength=n_rows) == 1
    np.testing.assert_array_equal(got[once], want[once])


# ResUNet's 11 per-tap layers at B = 2 of the training pyramid: (N_out,
# Cin, Cout, K) with level rows 65536, 8704, 3072, 1536, 512, 512
RESUNET_LAYERS = [(65536, 1, 32, 343), (8704, 32, 64, 125),
                  (3072, 64, 128, 125), (1536, 128, 256, 125),
                  (512, 256, 512, 125), (512, 512, 1024, 125),
                  (512, 1024, 512, 125), (1536, 1024, 512, 125),
                  (3072, 768, 256, 125), (8704, 384, 256, 125),
                  (65536, 320, 128, 125)]
EXTREMES = [(1, 1, 1, 1), (2 ** 30, 1, 32, 343), (2 ** 30, 3, 48, 27),
            (200_000, 1024, 2048, 125), (100, 2048, 65536 * 4, 1),
            (5_000_000, 32, 32, 27), (40, 1, 33, 343), (40, 1, 32, 385)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", RESUNET_LAYERS + EXTREMES)
def test_wgrad_plan_keeps_scratch_and_grid_within_limits(shape, dtype):
    n_out, cin, cout, K = shape
    plan = cuda_conv.wgrad_plan(n_out, cin, cout, K, dtype)
    assert plan.S >= 1 and plan.scratch_bytes <= cuda_conv._WGRAD_SCRATCH
    if plan.kind == "cin1":
        assert cin == 1 and cout <= 32 and K <= cuda_conv._WGRAD_CIN1_MAX_K
        assert plan.rows % 32 == 0 and plan.rows >= 128
        tiles = -(-n_out // plan.rows)
        assert tiles < 2 ** 31 and tiles * K * cout * 4 == plan.scratch_bytes
    elif plan.kind == "mma":
        assert dtype == torch.bfloat16
        tiles_n = -(-cout // cuda_conv._WGRAD_MMA_TILE)
        assert tiles_n * plan.S <= 65535
        assert -(-cin // cuda_conv._WGRAD_MMA_TILE) <= 65535
        assert plan.S == 1 or plan.S * K * cin * cout * 4 == \
            plan.scratch_bytes
    else:
        assert plan.kind == "fma" and dtype == torch.float32
        assert -(-cout // cuda_conv._WGRAD_TILE) * plan.S <= 65535


def test_wgrad_plan_on_resunet_picks_the_stem_kernel_and_fills_the_card():
    plans = [cuda_conv.wgrad_plan(*s) for s in RESUNET_LAYERS]
    assert [p.kind for p in plans] == ["cin1"] + ["mma"] * 10
    for (n_out, cin, cout, K), p in zip(RESUNET_LAYERS[1:], plans[1:]):
        blocks = K * -(-cin // 128) * -(-cout // 128)
        # one segment where the blocks fill the SMs, else about two blocks
        # an SM (or a segment per 128 rows at most)
        if blocks >= 132:
            assert p.S == 1
        else:
            assert blocks * p.S >= 2 * 132 or p.S == -(-n_out // 128)


def test_wgrad_constants_mirror_the_kernel():
    c = _constants("sparse_conv_taps.cu")
    assert cuda_conv._WGRAD_MMA_TILE == c["kGM"] == c["kGN"]
    assert cuda_conv._WGRAD_CIN1_MAX_K == c["kW1Warps"] * c["kW1TapsAWarp"]
    assert cuda_conv._WGRAD_TILE == c["kWT"]


def _segmented_wgrad(x, g, nbr, S, dtype):
    """The kernels' order of work on the CPU: each tap's valid entries in
    row order cut into S contiguous segments, each segment's product in
    fp32 over operands rounded to dtype, the segments added in order."""
    f, gr = cuda_conv.round_to(x, dtype), cuda_conv.round_to(g, dtype)
    K = nbr.shape[0]
    out = torch.zeros((S, K, x.shape[1], g.shape[1]))
    for k in range(K):
        o = torch.nonzero((nbr[k] >= 0) & (nbr[k] < x.shape[0])).reshape(-1)
        chunk = -(-o.shape[0] // S)
        for s in range(S):
            e = o[s * chunk: (s + 1) * chunk]
            out[s, k] = f[nbr[k, e]].T @ gr[e]
    acc = out[0]
    for s in range(1, S):
        acc = acc + out[s]
    return acc


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-4)])
@pytest.mark.parametrize("shape", [(40, 30, 27, 4, 6, 3), (60, 70, 125, 1, 5, 1),
                                   (25, 20, 8, 9, 3, 4)])
def test_wgrad_segments_summed_in_order_match_plain_and_jax(shape, dtype,
                                                            tol):
    # tolerance: tol x max |dW| (fp32 sums in another order); the JAX
    # reference is the gradient of its sparse_conv in fp32 over operands
    # rounded as the port rounds them
    n_in, n_out, K, cin, cout, S = shape
    rng = np.random.default_rng(n_in + K)
    nbr = np.stack([np.where(rng.random(n_out) < 0.5,
                             rng.permutation(max(n_in, n_out))[:n_out], -1)
                    for _ in range(K)])
    nbr = np.where(nbr < n_in, nbr, -1)
    x = rng.normal(size=(n_in, cin)).astype(np.float32)
    g = rng.normal(size=(n_out, cout)).astype(np.float32)
    w = rng.normal(size=(K, cin, cout)).astype(np.float32)
    xr = n(cuda_conv.round_to(t(x), dtype))
    gr = n(cuda_conv.round_to(t(g), dtype))
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jax_sparse_conv(jnp.asarray(xr), a, jnp.asarray(nbr))
        * jnp.asarray(gr)))(jnp.asarray(w)))
    plain = n(cuda_conv.sparse_conv_wgrad(t(x), t(g), t(nbr), dtype))
    seg = n(_segmented_wgrad(t(x), t(g), t(nbr), S, dtype))
    scale = float(np.abs(want).max())
    assert np.abs(plain - want).max() <= tol * scale
    assert np.abs(seg - want).max() <= tol * scale


@pytest.mark.parametrize("shape,dtype,kind", [
    ((900, 3, 48, 27), torch.bfloat16, "mma"),  # rows zero-padded to 8
    ((400, 20, 7, 27), torch.bfloat16, "mma"),  # odd Cout: scalar stores
    ((100, 1, 5, 343), torch.bfloat16, "cin1"),  # stem kernel, Cout < 32
    ((100, 1, 5, 343), torch.float32, "cin1"),
    ((900, 3, 48, 27), torch.float32, "fma")])
def test_wgrad_plan_routes_the_forced_edge_cases(shape, dtype, kind):
    # the shapes chip_smoke's wgrad_forced_cases holds to the plain
    # version on the card reach the kernel paths they are there for
    assert cuda_conv.wgrad_plan(*shape, dtype).kind == kind


def test_count_forms_source_stays_out_of_the_kernel_library():
    # csrc/bench/row_count_forms.cu times gather_rows.cu's own count and
    # placement against two other forms; it includes that source, so it
    # must not be linked into the library beside it
    src = PKG / "csrc" / "bench" / "row_count_forms.cu"
    assert '#include "../gather_rows.cu"' in src.read_text()
    assert src not in _build._sources()
    assert all(p.parent == PKG / "csrc" for p in _build._sources())
