"""Full-pipeline integration tests (reference api/ + it/ suites):
index → finalize → encrypted query → selective re-encryption → restore.
"""

import numpy as np
import pytest

from fspann.api.system import ForwardSecureANNSystem
from fspann.config import SystemConfig, PaperConfig, RuntimeConfig, EvalConfig
from fspann.io import groundtruth


DIM = 16
N = 1500


def small_cfg(**runtime_kw):
    return SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=600, max_global_candidates=600,
                              block_size=32, **runtime_kw),
        eval=EvalConfig(k_variants=(1, 10)),
    ).validate()


@pytest.fixture
def corpus(rng):
    centers = rng.normal(size=(16, DIM)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, N)] + \
        rng.normal(size=(N, DIM)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 20)] + \
        rng.normal(size=(20, DIM)).astype(np.float32)
    return base, queries


def make_system(tmp_path, name="sys"):
    return ForwardSecureANNSystem(small_cfg(), str(tmp_path / name), DIM,
                                  query_batch=8)


def test_full_pipeline(tmp_path, corpus):
    base, queries = corpus
    sys_ = make_system(tmp_path)
    try:
        assert sys_.index_stream(base, batch_size=400) == N
        sys_.finalize_for_search()
        gtm = groundtruth.precompute(base, queries, k=10)
        agg = sys_.run_queries(queries, gtm, base)
        assert agg.num_queries == 20
        assert agg.recall_at_k[10] > 0.9, agg.paper_line()
        assert agg.ratio_at_k[10] < 1.05
        assert agg.mean_cand_decrypted > 0
        # encrypted query path returns exact distances
        tok = sys_.create_token(queries[0], 5)
        res = sys_.search(tok)
        assert len(res) == 5
        d0 = np.linalg.norm(base[res[0].id] - queries[0])
        assert abs(res[0].distance - d0) < 1e-3
    finally:
        sys_.shutdown()


def test_query_before_finalize_raises(tmp_path, corpus):
    base, queries = corpus
    sys_ = make_system(tmp_path)
    try:
        sys_.index_stream(base[:1200], batch_size=600)
        tok = sys_.create_token(queries[0], 5)
        with pytest.raises(Exception, match="finaliz"):
            sys_.search(tok)
    finally:
        sys_.shutdown()


def test_dimension_mismatch_raises(tmp_path, corpus):
    base, _ = corpus
    sys_ = make_system(tmp_path)
    try:
        with pytest.raises(ValueError):
            sys_.batch_insert(np.arange(5), np.zeros((5, DIM + 1), np.float32))
        with pytest.raises(ValueError):
            bad = np.zeros((5, DIM), np.float32)
            bad[0, 0] = np.nan
            sys_.batch_insert(np.arange(5), bad)
    finally:
        sys_.shutdown()


def test_selective_reencryption_and_query_stability(tmp_path, corpus):
    """Recall stable across rotation epochs (BASELINE.json config 4)."""
    base, queries = corpus
    sys_ = make_system(tmp_path)
    try:
        sys_.index_stream(base, batch_size=500)
        sys_.finalize_for_search()
        gtm = groundtruth.precompute(base, queries, k=10)
        agg1 = sys_.run_queries(queries, gtm, base)
        r1 = agg1.recall_at_k[10]
        rep = sys_.run_selective_reencryption()
        assert rep["reencrypted"] > 0
        assert rep["new_version"] == 2
        # queries still work against mixed-version ciphertexts
        sys_.profiler.clear_rows()
        agg2 = sys_.run_queries(queries, gtm, base)
        assert agg2.recall_at_k[10] == pytest.approx(r1, abs=1e-9), \
            "rotation must not change routing results"
    finally:
        sys_.shutdown()


def test_deletion_excluded_from_results(tmp_path, corpus):
    base, queries = corpus
    sys_ = make_system(tmp_path)
    try:
        sys_.index_stream(base, batch_size=500)
        sys_.finalize_for_search()
        tok = sys_.create_token(queries[0], 10)
        res = sys_.search(tok)
        victim = res[0].id
        sys_.delete([victim])
        res2 = sys_.search(sys_.create_token(queries[0], 10))
        assert victim not in [r.id for r in res2]
    finally:
        sys_.shutdown()


def test_restore_from_disk(tmp_path, corpus):
    """Shutdown → reopen → restore → identical query results (reference
    SuperSystemLifecycleIT; routing state rebuilt deterministically from the
    persisted bank stats + decrypted ciphertexts)."""
    base, queries = corpus
    sys1 = make_system(tmp_path)
    sys1.index_stream(base, batch_size=500)
    sys1.finalize_for_search()
    tok = sys1.create_token(queries[0], 10)
    res1 = sys1.search(tok)
    sys1.shutdown()

    sys2 = make_system(tmp_path)   # same base_dir
    try:
        n = sys2.restore_index_from_disk()
        assert n == N
        res2 = sys2.search(sys2.create_token(queries[0], 10))
        assert [r.id for r in res1] == [r.id for r in res2]
        np.testing.assert_allclose([r.distance for r in res1],
                                   [r.distance for r in res2], rtol=1e-5)
    finally:
        sys2.shutdown()


def test_export_artifacts(tmp_path, corpus):
    base, queries = corpus
    sys_ = make_system(tmp_path)
    try:
        sys_.index_stream(base, batch_size=500)
        sys_.finalize_for_search()
        gtm = groundtruth.precompute(base, queries[:5], k=10)
        sys_.run_queries(queries[:5], gtm, base)
        sys_.run_selective_reencryption()
        out = str(tmp_path / "results")
        sys_.export_artifacts(out)
        import os
        for f in ("profiler_metrics.csv", "summary.csv", "accuracy.csv",
                  "cost.csv", "metrics_summary.txt", "reencrypt_metrics.csv"):
            assert os.path.exists(os.path.join(out, f)), f
    finally:
        sys_.shutdown()


def test_adaptive_retry_triggers(tmp_path, corpus):
    """With probes=1 and tiny refinement limit, underfilled queries retry
    once with widened probes (reference QueryServiceImpl:327-337)."""
    base, queries = corpus
    cfg = small_cfg(probe_override=1, retry_probes=6)
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / "sys"), DIM,
                                  query_batch=8)
    try:
        sys_.index_stream(base, batch_size=500)
        sys_.finalize_for_search()
        # Starve stage A: tombstone 90% of the corpus so decrypted < 10*K,
        # forcing the retry branch.
        sys_.delete(np.arange(0, N, dtype=np.int64)[:- (N // 10)])
        gtm = groundtruth.precompute(base, queries, k=10)
        sys_.run_queries(queries, gtm)
        retried = [r for r in sys_.profiler.rows if r.retried]
        assert retried, "expected at least one adaptive retry"
    finally:
        sys_.shutdown()


def test_system_level_forward_security_game(tmp_path, corpus):
    """System-level G1/G3 (reference it/adversarial/
    ForwardSecurityAdversarialIT): an adversary snapshots the current
    session key, queries touch a candidate set, S-R.E migrates exactly the
    touched set, and the snapshot decrypts none of the migrated records."""
    from fspann.crypto import aesgcm
    from fspann.types import aad_for

    base, queries = corpus
    sys_ = make_system(tmp_path)
    try:
        sys_.index_stream(base, batch_size=500)
        sys_.finalize_for_search()
        stolen = aesgcm.GcmKey(sys_.km.get_version(1).key)

        sys_.search(sys_.create_token(queries[0], 10))
        touched_before = sys_.tracker.unique_count()
        assert touched_before > 10   # all decrypted candidates, not just top-K

        rep = sys_.run_selective_reencryption()
        assert rep["reencrypted"] == touched_before

        # the stolen v1 key opens zero migrated records
        migrated = [pid for pid in range(N)
                    if sys_.store.key_version_of(pid) == 2]
        assert len(migrated) == touched_before
        opened = 0
        for pid in migrated[:50]:
            m = sys_.store.meta.get(pid)
            _rid, _kv, _dim, iv, ct = sys_.store._reader(2).read_record(
                m.arena_off)
            for v in (1, 2):
                try:
                    stolen.open(iv, ct, aad_for(pid, v, DIM))
                    opened += 1
                except ValueError:
                    pass
        assert opened == 0
        # untouched records remain on v1 (lazy migration)
        assert sys_.store.meta.count_with_version(1) == N - touched_before
    finally:
        sys_.shutdown()


def test_cpu_encode_backend_equivalent(tmp_path, corpus):
    """encode_backend=cpu produces a working index with the same recall
    semantics (codes may differ at f32 bucket boundaries across backends,
    but queries encode on the same backend as the corpus)."""
    import dataclasses
    base, queries = corpus
    cfg = small_cfg()
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, encode_backend="cpu"))
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / "sys"), DIM,
                                  query_batch=8)
    try:
        sys_.index_stream(base, batch_size=500)
        sys_.finalize_for_search()
        gtm = groundtruth.precompute(base, queries, k=10)
        agg = sys_.run_queries(queries, gtm, base)
        assert agg.recall_at_k[10] > 0.9
    finally:
        sys_.shutdown()


def test_fast_restore_from_table(tmp_path, corpus):
    """Fast restore loads the persisted partition table (no decrypt-all) and
    reproduces results exactly; a config change falls back to the rebuild."""
    import os
    import dataclasses
    base, queries = corpus
    sys1 = make_system(tmp_path)
    sys1.index_stream(base, batch_size=500)
    sys1.finalize_for_search()
    res1 = sys1.search(sys1.create_token(queries[0], 10))
    sys1.shutdown()
    assert os.path.exists(str(tmp_path / "sys" / "table.npz"))

    sys2 = make_system(tmp_path)
    try:
        n = sys2.restore_index_from_disk()
        assert n == N
        # fast path: nothing was staged (no decrypt-all happened)
        assert sys2.index._staged == 0
        res2 = sys2.search(sys2.create_token(queries[0], 10))
        assert [r.id for r in res1] == [r.id for r in res2]
    finally:
        sys2.shutdown()

    # mismatched profile -> falls back to decrypt-and-rebuild
    cfg3 = small_cfg(probe_override=2)
    cfg3 = dataclasses.replace(
        cfg3, paper=dataclasses.replace(cfg3.paper, seed=99))
    sys3 = ForwardSecureANNSystem(cfg3, str(tmp_path / "sys3"), DIM,
                                  query_batch=8)
    try:
        sys3.index_stream(base, batch_size=500)
        sys3.finalize_for_search()
        sys3.shutdown()
        # reopen with a DIFFERENT block size: table must be rejected
        cfg4 = dataclasses.replace(
            cfg3, runtime=dataclasses.replace(cfg3.runtime, block_size=16))
        sys4 = ForwardSecureANNSystem(cfg4, str(tmp_path / "sys3"), DIM,
                                      query_batch=8)
        try:
            # bank hyperparams match so the bank loads; table is rejected by
            # block-size mismatch -> slow path re-stages everything
            n = sys4.restore_index_from_disk()
            assert n == N
            assert sys4.index._n_rows == N
        finally:
            sys4.shutdown()
    finally:
        pass


def test_fast_restore_reseeds_tombstones(tmp_path, corpus):
    base, queries = corpus
    sys1 = make_system(tmp_path)
    sys1.index_stream(base, batch_size=500)
    sys1.finalize_for_search()
    victim = sys1.search(sys1.create_token(queries[0], 5))[0].id
    sys1.delete([victim])
    sys1.shutdown()

    sys2 = make_system(tmp_path)
    try:
        sys2.restore_index_from_disk()
        assert sys2.index._staged == 0            # fast path taken
        assert victim in sys2.index._deleted      # tombstones reseeded
        res = sys2.search(sys2.create_token(queries[0], 5))
        assert victim not in [r.id for r in res]
    finally:
        sys2.shutdown()


def test_finalize_idempotent(tmp_path, corpus):
    base, queries = corpus
    sys_ = make_system(tmp_path)
    try:
        sys_.index_stream(base, batch_size=500)
        sys_.finalize_for_search()
        sys_.finalize_for_search()   # no-op, no error
        assert sys_.index.size == N
    finally:
        sys_.shutdown()


def test_token_under_deleted_key_version_rejected(tmp_path, corpus):
    """A query token encrypted under a securely deleted key version cannot
    be served (forward security applies to tokens too)."""
    base, queries = corpus
    sys_ = make_system(tmp_path)
    try:
        sys_.index_stream(base, batch_size=500)
        sys_.finalize_for_search()
        old_tok = sys_.create_token(queries[0], 5)      # under v1
        # migrate everything off v1 and delete it
        sys_.rotation.force_rotate_now()
        sys_.store.reencrypt_all()
        sys_.rotation.force_rotate_now()
        assert sys_.rotation.finalize_rotation() == [1]
        # diagnosable error, not a downstream tag-verification failure:
        # the service refuses retired/unknown token key versions up front
        from fspann.query.service import StaleTokenError
        with pytest.raises(StaleTokenError, match="retired or unknown"):
            sys_.search(old_tok)
        # fresh tokens still work
        res = sys_.search(sys_.create_token(queries[0], 5))
        assert len(res) == 5
    finally:
        sys_.shutdown()


def test_undelete_restores_visibility(tmp_path, corpus):
    base, queries = corpus
    sys_ = make_system(tmp_path)
    try:
        sys_.index_stream(base, batch_size=500)
        sys_.finalize_for_search()
        victim = sys_.search(sys_.create_token(queries[0], 5))[0].id
        sys_.delete([victim])
        assert victim not in [r.id for r in
                              sys_.search(sys_.create_token(queries[0], 5))]
        sys_.undelete([victim])
        res = sys_.search(sys_.create_token(queries[0], 5))
        assert res[0].id == victim
    finally:
        sys_.shutdown()


def test_query_cache_does_not_alias_nearby_queries(tmp_path, corpus):
    """Two distinct queries that share LSH codes must NOT be served each
    other's cached results — the cache keys on the plaintext query digest
    (reference StringKeyedCache keys by the query string)."""
    base, queries = corpus
    sys_ = make_system(tmp_path)
    try:
        sys_.index_stream(base, batch_size=500)
        sys_.finalize_for_search()
        q1 = queries[0]
        q2 = q1 + 1e-4                      # nearby: same routing codes
        t1 = sys_.create_token(q1, 5)
        t2 = sys_.create_token(q2, 5)
        assert np.array_equal(t1.codes, t2.codes), "test premise: same codes"
        r1 = sys_.search(t1)
        r2 = sys_.search(t2)
        d1 = [r.distance for r in r1]
        d2 = [r.distance for r in r2]
        assert d1 != d2                      # exact distances differ
        # identical plaintext query DOES hit the cache (same digest)
        r1b = sys_.search(sys_.create_token(q1, 5))
        assert [r.id for r in r1b] == [r.id for r in r1]
    finally:
        sys_.shutdown()


def test_rerank_pipeline_recall_and_budget(tmp_path, corpus):
    """Full-code rerank: decrypt set shrinks to the budget with recall held
    (the fine Hamming score ranks true neighbors into the truncated set)."""
    base, queries = corpus
    cfg = small_cfg(rerank_limit=150)
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / "rr"), DIM,
                                  query_batch=8)
    try:
        sys_.index_stream(base, batch_size=400)
        sys_.finalize_for_search()
        gtm = groundtruth.precompute(base, queries, k=10)
        agg = sys_.run_queries(queries, gtm, base)
        # decrypt budget enforced: nobody decrypts more than rerank_limit
        assert agg.mean_cand_decrypted <= 150
        assert agg.recall_at_k[10] > 0.85, agg.paper_line()
    finally:
        sys_.shutdown()


def test_rerank_fast_restore_roundtrip(tmp_path, corpus):
    """Fast restore persists the point codes; a restored system with rerank
    enabled returns bit-identical results."""
    base, queries = corpus
    cfg = small_cfg(rerank_limit=150)
    root = str(tmp_path / "rrr")
    sys_ = ForwardSecureANNSystem(cfg, root, DIM, query_batch=8)
    try:
        sys_.index_stream(base, batch_size=400)
        sys_.finalize_for_search()
        tok = sys_.create_token(queries[0], 10)
        before = [(r.id, round(r.distance, 5)) for r in sys_.search(tok)]
        sys_.flush_all()
    finally:
        sys_.shutdown()
    sys2 = ForwardSecureANNSystem(cfg, root, DIM, query_batch=8)
    try:
        assert sys2.restore_index_from_disk()
        assert sys2.index.point_codes is not None
        tok2 = sys2.create_token(queries[0], 10)
        after = [(r.id, round(r.distance, 5)) for r in sys2.search(tok2)]
        assert before == after
    finally:
        sys2.shutdown()


def test_fused_score_matches_device_refine(tmp_path, corpus):
    """The fused decrypt-and-score host path (C AES loop emits norms+dots,
    plaintext never reaches DRAM) returns the same ids as the device
    refine backend, and near-identical distances (float association
    differs), in both f32 and f16 storage."""
    base, queries = corpus
    for dtype in ("f32", "f16"):
        got = {}
        for backend in ("host", "device"):
            cfg = small_cfg(refine_backend=backend, storage_dtype=dtype)
            sys_ = ForwardSecureANNSystem(cfg, str(tmp_path /
                                                   f"fs_{dtype}_{backend}"),
                                          DIM, query_batch=8)
            try:
                sys_.index_stream(base, batch_size=400)
                sys_.finalize_for_search()
                toks = [sys_.create_token(q, 10) for q in queries]
                res = sys_.query_service.search_batch(toks)
                got[backend] = (res.ids.copy(), res.distances.copy())
            finally:
                sys_.shutdown()
        ids_h, d_h = got["host"]
        ids_d, d_d = got["device"]
        # distances must agree tightly; ids may swap only at exact ties
        np.testing.assert_allclose(d_h, d_d, rtol=1e-4, atol=1e-4)
        swapped = ids_h != ids_d
        if swapped.any():
            np.testing.assert_allclose(d_h[swapped], d_d[swapped],
                                       rtol=1e-4, atol=1e-4)
        assert (ids_h == ids_d).mean() > 0.95
