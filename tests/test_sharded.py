"""Sharded index on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax

from fspann.ops import coding, refine
from fspann.parallel.sharded import ShardedIndex, make_mesh


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device mesh")
def test_sharded_matches_bruteforce(rng):
    n, d, q, k = 4000, 16, 8, 10
    centers = rng.normal(size=(16, d)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    bank = coding.build_bank_from_sample(base[:1000], m=8, lam=2, tables=3,
                                         divisions=2, seed=13)
    mesh = make_mesh()
    idx = ShardedIndex(mesh, bank, block_size=32)
    idx.build(base)
    ids, dist = idx.query(queries, probes=4, refinement_limit=512, k=k)

    gt_ids, gt_dist = refine.bruteforce_topk(base, queries, k)
    hits = sum(len(set(ids[i].tolist()) & set(gt_ids[i].tolist()))
               for i in range(q))
    recall = hits / (q * k)
    assert recall > 0.9, f"sharded recall {recall}"
    # distances ascending and correct
    for i in range(q):
        live = ids[i] >= 0
        d_true = np.linalg.norm(base[ids[i][live]] - queries[i], axis=1)
        np.testing.assert_allclose(dist[i][live], d_true, rtol=1e-4)
        assert np.all(np.diff(dist[i][live]) >= -1e-6)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device mesh")
def test_sharded_padding_masked(rng):
    """N not divisible by device count: padded rows never appear."""
    n, d = 1003, 8
    base = rng.normal(size=(n, d)).astype(np.float32)
    bank = coding.build_bank_from_sample(base, m=6, lam=2, tables=2,
                                         divisions=2, seed=5)
    idx = ShardedIndex(make_mesh(), bank, block_size=16)
    idx.build(base)
    ids, dist = idx.query(base[:4], probes=3, refinement_limit=256, k=5)
    assert ids.max() < n
    # querying with a base vector finds itself at distance ~0
    assert (ids[:, 0] == np.arange(4)).all()
    np.testing.assert_allclose(dist[:, 0], 0, atol=1e-3)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device mesh")
def test_probe_shards_subset(rng):
    """probe_shards=N restricts results to the first N shards' rows
    (reference -Dprobe.shards, ForwardSecureANNSystem.java:1598-1617)."""
    n, d, q, k = 2048, 8, 4, 10
    base = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    bank = coding.build_bank_from_sample(base[:800], m=6, lam=2, tables=2,
                                         divisions=2, seed=13)
    idx = ShardedIndex(make_mesh(), bank, block_size=16)
    idx.build(base)
    nd = idx.n_devices
    subset = 2
    ids, dist = idx.query(queries, probes=3, refinement_limit=256, k=k,
                          probe_shards=subset)
    live = ids[ids >= 0]
    assert len(live), "subset probe returned nothing"
    assert (live < subset * idx.shard_rows).all(), \
        "id from an unprobed shard leaked into the merge"
    # full probe still sees all shards
    ids_full, _ = idx.query(queries, probes=3, refinement_limit=256, k=k)
    assert (ids_full[ids_full >= 0] >= subset * idx.shard_rows).any()
