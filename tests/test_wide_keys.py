"""Wide sort keys (runtime.wide_keys): full code-prefix partition order
past the reference's 63-bit key truncation.

The reference's ``computeKey`` (GreedyPartitioner.java:87-96) keeps only the
first 63 interleaved code bits, so at ``lambda*m > 63`` the partition order
is arbitrary within 63-bit ties.  Round-5 diagnostic
(scripts/diag_lambda3.py): on the glove family at lambda=3 the full
order recovers the ENTIRE truncation loss.  These tests pin the mechanism:

* key2 bit extraction against a numpy bit oracle;
* device/numpy partition builds agree and realize the full lexicographic
  code order;
* pair-aware find_center matches a numpy oracle (containment + closest
  flank under the 126-bit combined value);
* wide routing ≥ narrow routing recall at lambda=3 on a clustered corpus;
* narrow geometries (lambda*m <= 63): wide build == narrow build (key2 is
  all zeros — behavior is reference-exact either way);
* index service save/load round-trips the wide table and rejects a
  key-width mismatch (falls back to rebuild).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fspann.ops import coding, partition, routing


def _random_codes(rng, n, g, w):
    return rng.integers(0, 2 ** 32, size=(n, g, w), dtype=np.uint32)


def _key2_oracle(codes_row):
    """Bit-level oracle: key2 bit 62-(p-63) = code bit p for p in 63..125."""
    w = codes_row.shape[-1]
    bits = np.unpackbits(
        codes_row.astype(">u4").view(np.uint8))  # MSB-first, 32*w bits
    out = 0
    for p in range(63, min(126, 32 * w)):
        out = (out << 1) | int(bits[p])
    # left-align into 63 bits (bits beyond the code width are zero)
    out <<= 63 - (min(126, 32 * w) - 63)
    return np.int64(out)


def test_keys2_matches_bit_oracle():
    rng = np.random.default_rng(0)
    for w in (1, 2, 3, 4, 5):
        codes = _random_codes(rng, 8, 3, w)
        got = np.asarray(coding.keys2_from_codes(jnp.asarray(codes)))
        got_np = coding.keys2_from_codes_numpy(codes)
        np.testing.assert_array_equal(got, got_np)
        for i in range(8):
            for gi in range(3):
                assert got[i, gi] == _key2_oracle(codes[i, gi]), (w, i, gi)
        if w == 1:
            assert not got.any()   # <= 32 code bits: no secondary key


def test_wide_build_device_equals_numpy():
    rng = np.random.default_rng(1)
    g, n, w = 4, 301, 3
    codes = _random_codes(rng, n, g, w)
    codes_gn = np.ascontiguousarray(np.moveaxis(codes, 1, 0))
    keys_gn = np.ascontiguousarray(
        np.asarray(coding.keys_from_codes(jnp.asarray(codes))).T)
    td = partition.build_partitions(jnp.asarray(keys_gn),
                                    jnp.asarray(codes_gn), 32, wide=True)
    tn = partition.build_partitions_numpy(keys_gn, codes_gn, 32, wide=True)
    for a, b in zip(jax.tree.leaves(td), jax.tree.leaves(tn)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert td.min_key2 is not None and td.max_key2 is not None


def test_wide_build_realizes_full_code_order():
    """The flattened id order must equal np.lexsort over ALL code words."""
    rng = np.random.default_rng(2)
    g, n, w = 2, 200, 3
    codes = _random_codes(rng, n, g, w)
    # force 63-bit ties: same first two words, differ only in word 2
    codes[:, :, 0] = 7
    codes[:, :, 1] = 9
    codes_gn = np.ascontiguousarray(np.moveaxis(codes, 1, 0))
    keys_gn = np.ascontiguousarray(
        np.asarray(coding.keys_from_codes(jnp.asarray(codes))).T)
    t = partition.build_partitions_numpy(keys_gn, codes_gn, 16, wide=True)
    ids0 = np.arange(n, dtype=np.int32)
    for gi in range(g):
        cols = [codes_gn[gi][:, wd] for wd in range(w - 1, -1, -1)]
        # w1's LSB only reaches key/key2 up to bit 125; bits 126..127 of a
        # 4-word code would be outside — at w=3 (96 bits) all bits count.
        want = np.lexsort((ids0, *cols))
        got = np.asarray(t.ids[gi]).reshape(-1)[:n]
        np.testing.assert_array_equal(got, want)


def _find_center_oracle(table, qk, qk2):
    """Per (query, group): containing block under the pair order, else the
    closest flank by the combined 126-bit value."""
    g, p = np.asarray(table.min_key).shape
    mn = np.asarray(table.min_key).astype(object)
    mx = np.asarray(table.max_key).astype(object)
    mn2 = np.asarray(table.min_key2).astype(object)
    mx2 = np.asarray(table.max_key2).astype(object)
    lo_v = mn * (1 << 63) + mn2
    hi_v = mx * (1 << 63) + mx2
    out = np.zeros((len(qk), g), np.int32)
    for qi in range(len(qk)):
        for gi in range(g):
            v = int(qk[qi, gi]) * (1 << 63) + int(qk2[qi, gi])
            hit = [pi for pi in range(p)
                   if lo_v[gi, pi] <= v <= hi_v[gi, pi]]
            if hit:
                out[qi, gi] = hit[0]
                continue
            best, bd = 0, None
            for pi in range(p):
                d = min(abs(v - lo_v[gi, pi]), abs(v - hi_v[gi, pi]))
                if bd is None or d < bd:
                    best, bd = pi, d
            out[qi, gi] = best
    return out


def test_find_center_pair_matches_oracle():
    rng = np.random.default_rng(3)
    g, n, w = 3, 240, 3
    codes = _random_codes(rng, n, g, w)
    codes[:, :, 0] = 1          # force heavy 63-bit ties
    codes[:, :, 1] = rng.integers(0, 4, size=(n, g), dtype=np.uint32)
    codes_gn = np.ascontiguousarray(np.moveaxis(codes, 1, 0))
    keys_gn = np.ascontiguousarray(
        np.asarray(coding.keys_from_codes(jnp.asarray(codes))).T)
    t = partition.build_partitions_numpy(keys_gn, codes_gn, 16, wide=True)

    qcodes = _random_codes(rng, 32, g, w)
    qcodes[:, :, 0] = 1
    qcodes[:, :, 1] = rng.integers(0, 4, size=(32, g), dtype=np.uint32)
    qk = np.asarray(coding.keys_from_codes(jnp.asarray(qcodes)))
    qk2 = coding.keys2_from_codes_numpy(qcodes)
    got = np.asarray(routing.find_center(
        jax.tree.map(jnp.asarray, t), jnp.asarray(qk), jnp.asarray(qk2)))
    want = _find_center_oracle(t, qk, qk2)
    np.testing.assert_array_equal(got, want)


def _clustered(rng, n, nq, d=24):
    centers = rng.standard_normal((32, d)).astype(np.float32) * 4
    asg = rng.integers(0, 32, n)
    base = centers[asg] + rng.standard_normal((n, d)).astype(np.float32) * .4
    qi = rng.integers(0, n, nq)
    queries = base[qi] + rng.standard_normal((nq, d)).astype(np.float32) * .1
    return base, queries


def _route_recall(base, queries, bank, wide, probes=4, ref=512, k=10):
    codes, keys = coding.encode_numpy(base, bank)
    qc, qk = coding.encode_numpy(queries, bank)
    codes_gn = np.ascontiguousarray(np.moveaxis(codes, 1, 0))
    keys_gn = np.ascontiguousarray(keys.T)
    t = partition.build_partitions_numpy(keys_gn, codes_gn, 16, wide=wide)
    tomb = jnp.zeros(len(base), bool)
    res = routing.route(jax.tree.map(jnp.asarray, t), jnp.asarray(qc),
                        jnp.asarray(qk), tomb, probes, ref)
    ids = np.asarray(res.ids)
    # exact GT + exact rerank of the candidate set
    hits = 0
    for qi in range(len(queries)):
        d2 = ((base - queries[qi]) ** 2).sum(1)
        gt = np.argsort(d2, kind="stable")[:k]
        cand = ids[qi][ids[qi] >= 0]
        if len(cand):
            top = cand[np.argsort(d2[cand], kind="stable")[:k]]
            hits += len(set(top.tolist()) & set(gt.tolist()))
    return hits / (len(queries) * k)


def test_wide_recall_at_lambda3_not_worse():
    """lambda=3, m=24 (72-bit codes): wide order >= truncated order on a
    clustered corpus (the diagnostic's finding, shrunk to test scale)."""
    rng = np.random.default_rng(4)
    base, queries = _clustered(rng, 4000, 64)
    bank = coding.build_bank_from_sample(base[:500], 24, 3, 2, 2, seed=5)
    r_narrow = _route_recall(base, queries, bank, wide=False)
    r_wide = _route_recall(base, queries, bank, wide=True)
    assert r_wide >= r_narrow
    assert r_wide > 0.5          # sanity: the walk actually routes


def test_wide_noop_at_narrow_geometry():
    """lambda*m <= 63: key2 == 0 everywhere, so the wide build's order and
    boundaries equal the narrow build's (reference-exact either way)."""
    rng = np.random.default_rng(6)
    base, _ = _clustered(rng, 1200, 1)
    bank = coding.build_bank_from_sample(base[:300], 24, 2, 2, 2, seed=7)
    codes, keys = coding.encode_numpy(base, bank)
    codes_gn = np.ascontiguousarray(np.moveaxis(codes, 1, 0))
    keys_gn = np.ascontiguousarray(keys.T)
    tn = partition.build_partitions_numpy(keys_gn, codes_gn, 32, wide=False)
    tw = partition.build_partitions_numpy(keys_gn, codes_gn, 32, wide=True)
    np.testing.assert_array_equal(tn.ids, tw.ids)
    np.testing.assert_array_equal(tn.min_key, tw.min_key)
    assert not tw.min_key2.any() and not tw.max_key2.any()


def test_service_wide_table_save_load_roundtrip(tmp_path):
    """Wide table checkpoints round-trip; a key-width mismatch refuses the
    fast path (returns False -> caller rebuilds)."""
    import dataclasses

    from fspann.config import SystemConfig
    from fspann.index.service import PartitionedIndex

    rng = np.random.default_rng(8)
    base, queries = _clustered(rng, 2000, 16)
    cfg = SystemConfig()
    cfg = dataclasses.replace(
        cfg,
        paper=dataclasses.replace(cfg.paper, m=24, lam=3, tables=2,
                                  divisions=2),
        runtime=dataclasses.replace(cfg.runtime, wide_keys="auto",
                                    encode_backend="cpu")).validate()
    path = str(tmp_path / "table.npz")
    bank_path = str(tmp_path / "bank.npz")
    idx = PartitionedIndex(cfg, base.shape[1], bank_path=bank_path,
                           table_path=path)
    idx.stage(np.arange(len(base)), base)
    idx.finalize()
    assert idx.table.min_key2 is not None

    qc, qk = idx.encode_queries(queries)
    r1 = idx.route_batch(qc, qk, probes=3, refinement_limit=256)

    idx2 = PartitionedIndex(cfg, base.shape[1], bank_path=bank_path,
                            table_path=path)
    assert idx2.load_table(path)
    assert idx2.table.min_key2 is not None
    r2 = idx2.route_batch(qc, qk, probes=3, refinement_limit=256)
    np.testing.assert_array_equal(np.asarray(r1.ids), np.asarray(r2.ids))

    # width mismatch: a narrow-config service must refuse the wide file
    cfg_narrow = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, wide_keys="off"))
    idx3 = PartitionedIndex(cfg_narrow, base.shape[1], bank_path=bank_path,
                            table_path=path)
    assert not idx3.load_table(path)


def test_mesh_wide_matches_single_chip():
    """Mesh per-shard wide tables route against the same order the
    single-chip wide build uses (smoke: mesh build runs and returns
    candidates at lambda=3 with wide on)."""
    from jax.sharding import Mesh

    from fspann.parallel.sharded import ShardedIndex

    devs = np.array(jax.devices("cpu")[:4])
    if devs.size < 4:
        pytest.skip("needs 4 virtual devices")
    rng = np.random.default_rng(9)
    base, queries = _clustered(rng, 2048, 16)
    bank = coding.build_bank_from_sample(base[:300], 24, 3, 2, 2, seed=11)
    with Mesh(devs, ("shard",)) as mesh:
        idx = ShardedIndex(mesh, bank, block_size=16, wide_keys=True)
        idx.build(base, keep_base=False, keep_codes=True, keep_bits=False)
        assert idx.table.min_key2 is not None
        ids, _ = idx.route(queries, probes=3, refinement_limit=128)
        assert (np.asarray(ids) >= 0).any()
