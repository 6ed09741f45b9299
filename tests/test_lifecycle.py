"""Coordinator, buffered inserts, negative paths, key-retention lifecycle
(reference it/ SuperFailureModeIT + SelectiveReencCoordinator tests)."""

import os

import numpy as np
import pytest

from fspann.api.system import ForwardSecureANNSystem
from fspann.config import (EvalConfig, PaperConfig, RuntimeConfig,
                               SystemConfig)
from fspann.store.write_buffer import BufferedInserter

DIM = 12


def cfg():
    return SystemConfig(
        paper=PaperConfig(m=6, lam=2, divisions=2, tables=2, seed=5),
        runtime=RuntimeConfig(refinement_limit=300, max_global_candidates=300,
                              block_size=32),
        eval=EvalConfig(k_variants=(1, 5)),
    ).validate()


def test_buffered_inserter_flush_threshold():
    got = []
    buf = BufferedInserter(lambda i, v: got.append((i.copy(), v.copy())),
                           dim=3, flush_threshold=4)
    for i in range(10):
        buf.add(i, np.full(3, i, np.float32))
    assert len(got) == 2            # two automatic flushes of 4
    assert len(buf) == 2
    buf.flush()
    assert len(got) == 3
    all_ids = np.concatenate([g[0] for g in got])
    np.testing.assert_array_equal(np.sort(all_ids), np.arange(10))
    with pytest.raises(ValueError):
        buf.add(11, np.zeros(4, np.float32))


def test_single_insert_path_via_buffer(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(cfg(), str(tmp_path / "db"), DIM)
    try:
        vecs = rng.normal(size=(1200, DIM)).astype(np.float32)
        for i, v in enumerate(vecs):
            sys_.insert(i, v)
        sys_.finalize_for_search()   # flushes the buffer
        assert sys_.index.size == 1200
        res = sys_.search(sys_.create_token(vecs[7], 1))
        assert res[0].id == 7
    finally:
        sys_.shutdown()


def test_coordinator_csv_and_counters(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(cfg(), str(tmp_path / "db"), DIM)
    try:
        sys_.index_stream(rng.normal(size=(1100, DIM)).astype(np.float32),
                          batch_size=600)
        sys_.finalize_for_search()
        sys_.search(sys_.create_token(
            rng.normal(size=DIM).astype(np.float32), 5))
        rep = sys_.run_selective_reencryption()
        assert rep["reencrypted"] > 0
        csv_path = str(tmp_path / "db" / "reencrypt_metrics.csv")
        assert os.path.exists(csv_path)
        lines = open(csv_path).read().strip().splitlines()
        assert len(lines) == 2 and lines[0].startswith("timestamp")
        assert sys_.metrics.counters["reenc.passes"] == 1
        # second pass appends
        sys_.search(sys_.create_token(
            rng.normal(size=DIM).astype(np.float32), 5))
        sys_.run_selective_reencryption()
        assert len(open(csv_path).read().strip().splitlines()) == 3
    finally:
        sys_.shutdown()


def test_query_cache_hit(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(cfg(), str(tmp_path / "db"), DIM)
    try:
        sys_.index_stream(rng.normal(size=(1100, DIM)).astype(np.float32),
                          batch_size=600)
        sys_.finalize_for_search()
        q = rng.normal(size=DIM).astype(np.float32)
        r1 = sys_.search(sys_.create_token(q, 5))
        r2 = sys_.search(sys_.create_token(q, 5))   # same codes -> cache hit
        assert [x.id for x in r1] == [x.id for x in r2]
        assert sys_.metrics.counters.get("query.cache_hits", 0) == 1
    finally:
        sys_.shutdown()


def test_key_retention_enforcement(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(cfg(), str(tmp_path / "db"), DIM)
    try:
        sys_.index_stream(rng.normal(size=(1100, DIM)).astype(np.float32),
                          batch_size=600)
        sys_.finalize_for_search()
        # rotate + migrate everything several times, then finalize rotation
        for _ in range(4):
            sys_.rotation.force_rotate_now()
            sys_.store.reencrypt_all()
        dropped = sys_.rotation.finalize_rotation()
        assert dropped == [1, 2, 3]
        # all data still readable under the latest version
        out, ok = sys_.store.load_decrypt_batch(np.arange(1100))
        assert ok.all()
        # retired arenas are gone
        for v in dropped:
            assert not os.path.exists(sys_.store._arena_path(v))
    finally:
        sys_.shutdown()


def test_empty_index_finalize_raises(tmp_path):
    sys_ = ForwardSecureANNSystem(cfg(), str(tmp_path / "db"), DIM)
    try:
        with pytest.raises(RuntimeError, match="nothing staged"):
            sys_.finalize_for_search()
    finally:
        sys_.shutdown()


def test_stage_after_finalize_raises(tmp_path, rng):
    sys_ = ForwardSecureANNSystem(cfg(), str(tmp_path / "db"), DIM)
    try:
        sys_.index_stream(rng.normal(size=(1100, DIM)).astype(np.float32),
                          batch_size=600)
        sys_.finalize_for_search()
        with pytest.raises(RuntimeError, match="finalized"):
            sys_.batch_insert(np.array([99999]),
                              rng.normal(size=(1, DIM)).astype(np.float32))
    finally:
        sys_.shutdown()


def test_compact_storage_and_undelete_window(tmp_path, rng):
    """compact_storage reclaims re-encryption garbage; undelete works before
    compaction and degrades gracefully (ok=False, no crash) after it."""
    sys_ = ForwardSecureANNSystem(cfg(), str(tmp_path / "db"), DIM)
    try:
        vecs = rng.normal(size=(1100, DIM)).astype(np.float32)
        sys_.index_stream(vecs, batch_size=600)
        sys_.finalize_for_search()
        sys_.rotation.force_rotate_now()
        sys_.store.reencrypt_ids(np.arange(500))
        sys_.delete([7])
        before = sys_.store.size_bytes()
        rep = sys_.compact_storage()
        assert rep["bytes_freed"] > 0
        assert sys_.store.size_bytes() < before
        # everything live still decrypts
        out, ok = sys_.store.load_decrypt_batch(np.arange(1100))
        assert ok.sum() == 1099 and not ok[7]
        # undelete after compaction: record is gone -> graceful failure
        sys_.undelete([7])
        out2, ok2 = sys_.store.load_decrypt_batch(np.array([7]))
        assert not ok2[0]
    finally:
        sys_.shutdown()


def test_immediate_reencryption_mode(tmp_path, rng):
    """reenc.mode=immediate: each search batch's touched set is migrated to
    the current key version right away, results unchanged
    (reference ForwardSecureANNSystem.java:1345-1360)."""
    import dataclasses
    from fspann.config import ReencryptionConfig
    base_cfg = cfg()
    imm = dataclasses.replace(
        base_cfg, reencryption=ReencryptionConfig(mode="immediate"))
    sys_ = ForwardSecureANNSystem(imm, str(tmp_path / "db"), DIM)
    try:
        vecs = rng.normal(size=(1100, DIM)).astype(np.float32)
        sys_.index_stream(vecs, batch_size=600)
        sys_.finalize_for_search()
        q = vecs[17]
        before = [(r.id, round(r.distance, 5))
                  for r in sys_.search(sys_.create_token(q, 5))]
        sys_.rotation.force_rotate_now()          # stale ciphertexts at v1
        # same plaintext query = cache hit (valid: rotation never changes
        # results) — bust the generation to force a real post-rotation pass
        sys_._cache_gen += 1
        res = sys_.search(sys_.create_token(q, 5))
        after = [(r.id, round(r.distance, 5)) for r in res]
        assert after == before                    # results unchanged
        # every candidate THIS query touched is already migrated to v2
        assert sys_.tracker.unique_count() == 0   # drained by immediate pass
        touched = sys_.query_service.last_stats[0].cand_decrypted
        assert touched > 0
        assert sys_.store.meta.count_with_version(2) >= touched
    finally:
        sys_.shutdown()


def test_restore_at_explicit_older_version(tmp_path, rng):
    """--restore-version: after multiple rotations, a restore pinned at an
    older LIVE version activates it; a securely deleted version refuses
    (reference -Drestore.version, ForwardSecureANNSystem.java:950-962)."""
    vecs = rng.normal(size=(1100, DIM)).astype(np.float32)
    sys_ = ForwardSecureANNSystem(cfg(), str(tmp_path / "db"), DIM)
    sys_.index_stream(vecs, batch_size=600)
    sys_.finalize_for_search()
    sys_.rotation.force_rotate_now()   # v2
    sys_.rotation.force_rotate_now()   # v3
    sys_.store.meta.save_index_version(3)
    sys_.shutdown()

    r = ForwardSecureANNSystem(cfg(), str(tmp_path / "db"), DIM)
    try:
        n = r.restore_index_from_disk(version=2)
        assert n == 1100
        assert r.rotation.pinned_version == 2
        res = r.search(r.create_token(vecs[9], 5))
        assert res[0].id == 9
    finally:
        r.shutdown()

    import pytest
    r2 = ForwardSecureANNSystem(cfg(), str(tmp_path / "db"), DIM)
    try:
        with pytest.raises(KeyError):
            r2.restore_index_from_disk(version=99)
    finally:
        r2.shutdown()
