"""The port's voxel hash table and hash-grid nearest neighbours
(umeregrobust_tpu_torch/ops/hashing.py, ops/gridnn.py) against the JAX
package's on the same seeded numpy inputs: the slots, the fingerprints,
every lookup and the grid's (dist, idx) and overflow count bit for bit
(tests/test_voxel_hash.py's and tests/test_pipeline_ops.py's cases)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from umeregrobust_tpu.ops import gridnn as jgrid
from umeregrobust_tpu.ops import hashing as jhash
from umeregrobust_tpu_torch import ops as port_ops
from umeregrobust_tpu_torch.ops import gridnn, hashing


def _coords(rng, n_keys):
    c = rng.integers(-512, 512, size=(n_keys, 4)).astype(np.int32)
    c[:, 0] = rng.integers(0, 8, size=n_keys)  # batch idx
    return np.unique(c, axis=0)


def _symmetric():
    base = []
    for x in range(-6, 7, 2):
        for y in range(-6, 7, 2):
            for z in range(-6, 7, 2):
                base.append((0, x, y, z))
                base.append((1, y, x, z))
    return np.unique(np.asarray(base, np.int32), axis=0)


def _padded(rng):
    c = _coords(rng, 2000)
    coords = np.concatenate([c, np.zeros((2048 - len(c), 4), np.int32)])
    return coords, np.arange(2048) < len(c)


CASES = {
    "padded": lambda rng: _padded(rng),
    "plain": lambda rng: (_coords(rng, 500), None),
    "symmetric": lambda rng: (_symmetric(), None),
    # wide coordinates: negative words and values past 2^16
    "wide": lambda rng: (np.unique(rng.integers(-2**31, 2**31 - 1,
                                                size=(300, 4)).astype(
                                                    np.int32), axis=0), None),
}


def _tables(coords, mask):
    mask = np.ones(len(coords), bool) if mask is None else mask
    jt = jhash.build_hash_table(jnp.asarray(coords), jnp.asarray(mask))
    pt = hashing.build_hash_table(t(coords), t(mask), device="cpu")
    return jt, pt, mask


@pytest.mark.parametrize("case", sorted(CASES))
def test_slots_and_fingerprints_are_jax_bit_for_bit(case):
    coords, mask = CASES[case](np.random.default_rng(0))
    jt, pt, _ = _tables(coords, mask)
    assert pt.slots.dtype == torch.int32 and pt.fps.dtype == torch.int32
    np.testing.assert_array_equal(n(pt.slots), np.asarray(jt.slots))
    np.testing.assert_array_equal(n(pt.fps), np.asarray(jt.fps).view(np.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lookups_are_jax_bit_for_bit(case):
    rng = np.random.default_rng(1)
    coords, mask = CASES[case](rng)
    jt, pt, mask = _tables(coords, mask)
    absent = coords + np.array([0, 99999, 0, 0], np.int32)
    q = np.concatenate([coords, absent, coords[::-1]])
    q_mask = rng.uniform(size=len(q)) > 0.2
    for qm in (None, q_mask):  # every query; masked queries
        want = np.asarray(jhash.lookup(jt, jnp.asarray(q), None if qm is None
                                       else jnp.asarray(qm)))
        got = n(hashing.lookup(pt, t(q), None if qm is None else t(qm)))
        np.testing.assert_array_equal(got, want)
    # every inserted key is found at its row; absent keys miss
    got = n(hashing.lookup(pt, t(coords)))
    np.testing.assert_array_equal(got[mask], np.flatnonzero(mask))
    assert np.all(n(hashing.lookup(pt, t(absent))) == -1)


def test_lookup_reads_its_stop_condition_every_few_rounds():
    # probe sequences of many rounds: rounds after every query resolved
    # change nothing, so checking every CHECK_EVERY rounds gives JAX's bits
    c = np.stack([np.zeros(600, np.int32), np.arange(600, dtype=np.int32),
                  np.zeros(600, np.int32), np.zeros(600, np.int32)], 1)
    jt, pt, _ = _tables(c, None)
    q = np.concatenate([c, c + np.array([0, 0, 1, 0], np.int32)])
    for max_probes in (3, 128):
        want = np.asarray(jhash.lookup(jt, jnp.asarray(q),
                                       max_probes=max_probes))
        got = n(hashing.lookup(pt, t(q), max_probes=max_probes))
        np.testing.assert_array_equal(got, want)
    assert hashing.ROUNDS["lookup"] % hashing.CHECK_EVERY == 0


def _grid_case(seed=0, n_pts=700, n_q=200):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-5, 5, size=(n_pts, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, size=(n_q, 3)).astype(np.float32)
    return p, q, rng


@pytest.mark.parametrize("budget,chunk", [(64, 4096), (4, 37)])
def test_grid_nn_is_jax_bit_for_bit(budget, chunk, monkeypatch):
    # tests/test_pipeline_ops.py:79-92's case; budget 4 overflows cells
    p, q, _ = _grid_case()
    r = 0.5
    jg = jgrid.build_grid(jnp.asarray(p), jnp.ones(700, bool), cell=r)
    jd, ji = jgrid.nn_query(jg, jnp.asarray(q), radius=r, budget=budget)
    pg = gridnn.build_grid(t(p), torch.ones(700, dtype=torch.bool), cell=r,
                           device="cpu")
    monkeypatch.setattr(gridnn, "QUERY_CHUNK", chunk)  # results per query
    pd, pi = gridnn.nn_query(pg, t(q), radius=r, budget=budget)
    np.testing.assert_array_equal(n(pi), np.asarray(ji))
    np.testing.assert_array_equal(n(pd), np.asarray(jd))
    assert int(gridnn.overflow_count(pg, budget)) == int(
        jgrid.overflow_count(jg, budget))
    np.testing.assert_array_equal(n(pg.order), np.asarray(jg.order))
    np.testing.assert_array_equal(n(pg.start), np.asarray(jg.start))
    np.testing.assert_array_equal(n(pg.count), np.asarray(jg.count))


def test_grid_nn_masks_and_exactness():
    p, q, rng = _grid_case(seed=3)
    mask = rng.uniform(size=len(p)) > 0.3
    q_mask = rng.uniform(size=len(q)) > 0.2
    jg = jgrid.build_grid(jnp.asarray(p), jnp.asarray(mask), cell=0.6,
                          max_cells=400)
    jd, ji = jgrid.nn_query(jg, jnp.asarray(q), radius=0.6,
                            q_mask=jnp.asarray(q_mask))
    pg = gridnn.build_grid(t(p), t(mask), cell=0.6, max_cells=400,
                           device="cpu")
    pd, pi = gridnn.nn_query(pg, t(q), radius=0.6, q_mask=t(q_mask))
    np.testing.assert_array_equal(n(pi), np.asarray(ji))
    np.testing.assert_array_equal(n(pd), np.asarray(jd))
    # every cell indexed: float64 brute force over the valid points
    pg = gridnn.build_grid(t(p), t(mask), cell=0.6, device="cpu")
    assert int(gridnn.overflow_count(pg, 32)) == 0
    pd, pi = gridnn.nn_query(pg, t(q), radius=0.6, q_mask=t(q_mask))
    dd = np.linalg.norm(q[:, None].astype(np.float64) - p[None], axis=-1)
    dd[:, ~mask] = np.inf
    best = dd.argmin(1)
    hit = (dd[np.arange(len(q)), best] <= 0.6) & q_mask
    np.testing.assert_array_equal(n(pi) >= 0, hit)
    np.testing.assert_array_equal(n(pi)[hit], best[hit])


def test_ops_exports_the_table_and_grid_lazily():
    assert port_ops.build_grid is gridnn.build_grid
    assert port_ops.lookup is hashing.lookup
    assert port_ops.overflow_count is gridnn.overflow_count
    with pytest.raises(AttributeError):
        port_ops.not_a_name


def test_table_and_grid_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    c = np.zeros((4, 4), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hashing.build_hash_table(c, np.ones(4, bool))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gridnn.build_grid(np.zeros((4, 3), np.float32), np.ones(4, bool), 1.0)
    # numpy inputs on the CPU, where the caller asks for it
    table = hashing.build_hash_table(c[:1], np.ones(1, bool), device="cpu")
    assert n(hashing.lookup(table, c[:1])).tolist() == [0]
