"""PointStore + metadata log tests (reference common/ RocksDB suites)."""

import numpy as np
import pytest

from fspann.crypto.keys import KeyManager
from fspann.store.metadata import MetadataLog
from fspann.store.point_store import PointStore


@pytest.fixture
def store(tmp_path):
    km = KeyManager(str(tmp_path / "ks.blob"))
    s = PointStore(str(tmp_path / "db"), km, dim=8)
    yield s
    s.close()


def test_insert_load_roundtrip(store, rng):
    ids = np.arange(100)
    vecs = rng.normal(size=(100, 8)).astype(np.float32)
    store.insert_batch(ids, vecs)
    out, ok = store.load_decrypt_batch(np.array([0, 50, 99, -1, 1000]))
    assert ok.tolist() == [True, True, True, False, False]
    np.testing.assert_allclose(out[0], vecs[0], rtol=1e-6)
    np.testing.assert_allclose(out[1], vecs[50], rtol=1e-6)
    np.testing.assert_allclose(out[2], vecs[99], rtol=1e-6)
    assert not out[3].any()


def test_tombstones(store, rng):
    ids = np.arange(10)
    store.insert_batch(ids, rng.normal(size=(10, 8)).astype(np.float32))
    store.delete([3, 4])
    out, ok = store.load_decrypt_batch(np.arange(10))
    assert ok.tolist() == [True]*3 + [False]*2 + [True]*5
    assert store.meta.is_deleted(3)


def test_mixed_version_batch_decrypt(store, rng):
    v1 = rng.normal(size=(20, 8)).astype(np.float32)
    store.insert_batch(np.arange(20), v1)
    store.km.rotate()
    v2 = rng.normal(size=(20, 8)).astype(np.float32)
    store.insert_batch(np.arange(20, 40), v2)
    out, ok = store.load_decrypt_batch(np.arange(40))
    assert ok.all()
    np.testing.assert_allclose(out[:20], v1, rtol=1e-6)
    np.testing.assert_allclose(out[20:], v2, rtol=1e-6)
    assert store.key_version_of(5) == 1
    assert store.key_version_of(25) == 2


def test_reencrypt_selective(store, rng):
    vecs = rng.normal(size=(30, 8)).astype(np.float32)
    store.insert_batch(np.arange(30), vecs)
    store.km.rotate()
    rep = store.reencrypt_ids([5, 6, 7])
    assert rep.reencrypted == 3 and rep.failed == 0
    assert store.key_version_of(5) == 2
    assert store.key_version_of(4) == 1   # untouched stays old
    out, ok = store.load_decrypt_batch(np.arange(30))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)
    # idempotent: already-current skipped
    rep2 = store.reencrypt_ids([5, 6, 7])
    assert rep2.reencrypted == 0 and rep2.skipped_current == 3


def test_persistence_across_reopen(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks.blob"))
    s = PointStore(str(tmp_path / "db"), km, dim=8)
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    s.insert_batch(np.arange(50), vecs)
    s.meta.save_index_version(7)
    s.close()

    km2 = KeyManager(str(tmp_path / "ks.blob"))
    s2 = PointStore(str(tmp_path / "db"), km2, dim=8)
    assert s2.meta.index_version == 7
    out, ok = s2.load_decrypt_batch(np.arange(50))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)
    s2.close()


def test_crash_tail_ignored(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks.blob"))
    s = PointStore(str(tmp_path / "db"), km, dim=8)
    s.insert_batch(np.arange(10), rng.normal(size=(10, 8)).astype(np.float32))
    s.close()
    # simulate torn metadata write
    meta_path = str(tmp_path / "db" / "meta.log")
    with open(meta_path, "ab") as f:
        f.write(b"\x01garbage-partial-record")
    km2 = KeyManager(str(tmp_path / "ks.blob"))
    s2 = PointStore(str(tmp_path / "db"), km2, dim=8)
    assert len(s2.meta) == 10   # tail dropped, committed state intact
    out, ok = s2.load_decrypt_batch(np.arange(10))
    assert ok.all()
    s2.close()


def test_metadata_compaction(tmp_path):
    log = MetadataLog(str(tmp_path / "m.log"))
    for i in range(100):
        log.put(i, 1, 8, i * 10)
    for i in range(100):      # churn: rewrite all at v2
        log.put(i, 2, 8, i * 10)
    log.tombstone(7)
    log.save_index_version(3)
    size_before = log._f.tell()
    log.compact()
    log.close()
    log2 = MetadataLog(str(tmp_path / "m.log"))
    assert log2.get(8).key_version == 2
    assert log2.get(7) is None
    assert log2.index_version == 3
    assert log2.count_with_version(2) == 99
    import os
    assert os.path.getsize(str(tmp_path / "m.log")) < size_before


def test_restore_iter(store, rng):
    vecs = rng.normal(size=(25, 8)).astype(np.float32)
    store.insert_batch(np.arange(25), vecs)
    store.delete([2])
    got = {}
    for ids, vs in store.restore_iter(batch=10):
        for i, v in zip(ids, vs):
            got[int(i)] = v
    assert len(got) == 24 and 2 not in got
    np.testing.assert_allclose(got[3], vecs[3], rtol=1e-6)


def test_audit_drift_and_compaction(store, rng):
    vecs = rng.normal(size=(40, 8)).astype(np.float32)
    store.insert_batch(np.arange(40), vecs)
    drift = store.audit_drift()
    assert drift["meta_without_arena"] == []
    assert drift["arena_garbage_records"] == 0

    # churn: re-encrypt half within the SAME version space by rewriting
    store.km.rotate()
    store.reencrypt_ids(np.arange(20))      # v1 arena now has 20 garbage recs
    drift = store.audit_drift()
    assert drift["arena_garbage_records"] == 20
    assert drift["meta_without_arena"] == []

    freed = store.compact_version(1)
    assert freed > 0
    drift2 = store.audit_drift()
    assert drift2["arena_garbage_records"] == 0
    # all data still decryptable after compaction (offsets rewritten)
    out, ok = store.load_decrypt_batch(np.arange(40))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)


def test_compaction_survives_reopen(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks.blob"))
    s = PointStore(str(tmp_path / "db"), km, dim=8)
    vecs = rng.normal(size=(30, 8)).astype(np.float32)
    s.insert_batch(np.arange(30), vecs)
    km.rotate()
    s.reencrypt_ids(np.arange(15))
    s.compact_version(1)
    s.close()
    s2 = PointStore(str(tmp_path / "db"), KeyManager(str(tmp_path / "ks.blob")),
                    dim=8)
    out, ok = s2.load_decrypt_batch(np.arange(30))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)
    s2.close()


# -- round-2 hardening: compaction/undelete interplay (ADVICE r1) -------------

def test_undelete_after_compaction_cannot_resurrect(store, rng):
    """A tombstoned record dropped by compaction is purged: undelete is a
    no-op and no stale offset can reach the native GCM open (OOB guard)."""
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    store.insert_batch(np.arange(50), vecs)
    store.delete([49])                     # last record: compaction shrinks
    store.compact_version(1)               # past its old offset
    assert store.undelete([49]) == []
    out, ok = store.load_decrypt_batch(np.array([49]))
    assert not ok[0]
    # the live rest still decrypts at the rewritten offsets
    out, ok = store.load_decrypt_batch(np.arange(49))
    assert ok.all()
    np.testing.assert_allclose(out, vecs[:49], rtol=1e-6)


def test_undelete_after_retire_skips(store, rng):
    """Undelete of a point whose arena+key were securely deleted is skipped:
    the tombstone stays, queries keep returning ok=False, and the retired
    version's count stays zero."""
    vecs = rng.normal(size=(20, 8)).astype(np.float32)
    store.insert_batch(np.arange(20), vecs)
    store.delete([5])
    store.km.rotate()
    live = np.concatenate([np.arange(5), np.arange(6, 20)])
    store.reencrypt_ids(live)              # migrate everything live to v2
    store.meta.purge(5)                    # v1 drains fully
    assert store.retire_version(1)
    store.km.delete_version(1)
    # resurrect attempt on a different tombstone bound to a gone version
    store.insert_batch(np.array([30]), vecs[:1], key_version=2)
    assert store.undelete([5]) == []
    assert store.meta.count_with_version(1) == 0
    _, ok = store.load_decrypt_batch(np.array([5]))
    assert not ok[0]


def test_out_of_bounds_offset_degrades_gracefully(store, rng):
    """Stale metadata offsets past the arena end must yield ok=False, not a
    native out-of-bounds read."""
    vecs = rng.normal(size=(10, 8)).astype(np.float32)
    store.insert_batch(np.arange(10), vecs)
    store.meta.put(3, 1, 8, 10**9)          # poison: offset far past EOF
    out, ok = store.load_decrypt_batch(np.arange(10))
    assert not ok[3] and ok.sum() == 9


def test_compaction_crash_window_before_commit(tmp_path, rng):
    """Crash AFTER the new-epoch arena is written but BEFORE the commit
    record: reopen must resolve the old (file, offsets) pair and GC the
    orphan new-epoch file."""
    km = KeyManager(str(tmp_path / "ks.blob"))
    s = PointStore(str(tmp_path / "db"), km, dim=8)
    vecs = rng.normal(size=(30, 8)).astype(np.float32)
    s.insert_batch(np.arange(30), vecs)
    km.rotate()
    s.reencrypt_ids(np.arange(15))          # v1 arena now half garbage
    # simulate the torn compaction: write the new-epoch file only
    import os
    new_path = os.path.join(s.points_dir, "v1.e1.arena")
    open(new_path, "wb").write(b"\x00" * 64)
    s.close()
    s2 = PointStore(str(tmp_path / "db"), KeyManager(str(tmp_path / "ks.blob")),
                    dim=8)
    assert not os.path.exists(new_path)      # orphan GC'd
    out, ok = s2.load_decrypt_batch(np.arange(30))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)
    s2.close()


def test_compaction_epoch_survives_reopen_and_log_compaction(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks.blob"))
    s = PointStore(str(tmp_path / "db"), km, dim=8)
    vecs = rng.normal(size=(30, 8)).astype(np.float32)
    s.insert_batch(np.arange(30), vecs)
    km.rotate()
    s.reencrypt_ids(np.arange(15))
    s.compact_version(1)
    assert s.meta.arena_epoch(1) == 1
    s.meta.compact()                         # log rewrite must keep epochs
    s.compact_version(1)                     # second compaction: epoch 2
    assert s.meta.arena_epoch(1) == 2
    s.close()
    s2 = PointStore(str(tmp_path / "db"), KeyManager(str(tmp_path / "ks.blob")),
                    dim=8)
    assert s2.meta.arena_epoch(1) == 2
    out, ok = s2.load_decrypt_batch(np.arange(30))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)
    s2.close()


def test_duplicate_ids_in_one_batch_do_not_inflate_counts(tmp_path):
    log = MetadataLog(str(tmp_path / "m.log"))
    log.put_batch(np.array([1, 2, 2, 3, 2]), 1, 8,
                  np.array([10, 20, 30, 40, 50]))
    assert log.count_with_version(1) == 3
    assert log.get(2).arena_off == 50        # last occurrence wins
    for pid in (1, 2, 3):
        log.tombstone(pid)
    assert log.count_with_version(1) == 0    # safe-to-delete reachable
    log.close()
    log2 = MetadataLog(str(tmp_path / "m.log"))
    assert log2.count_with_version(1) == 0
    log2.close()


def test_load_score_batch_matches_unfused(store, rng):
    """Fused decrypt-and-score (plaintext never leaves L1) must reproduce
    the unfused path's norms and einsum dots exactly — mixed key versions,
    pads, and missing ids included."""
    v1 = rng.normal(size=(20, 8)).astype(np.float32)
    store.insert_batch(np.arange(20), v1)
    store.km.rotate()
    v2 = rng.normal(size=(20, 8)).astype(np.float32)
    store.insert_batch(np.arange(20, 40), v2)
    store.delete([7])

    # 3 queries x 4 rows/query, with pads and a missing id
    flat = np.array([0, 25, 7, -1,      # q0: one tombstoned, one pad
                     39, 1, 1000, 2,    # q1: one out-of-range
                     30, 31, 32, 33],   # q2
                    np.int64)
    qvecs = rng.normal(size=(3, 8)).astype(np.float32)

    vecs, ok_ref = store.load_decrypt_batch(flat)
    norms = np.full(len(flat), -1.0, np.float32)   # poisoned staging
    dots = np.full(len(flat), -1.0, np.float32)
    ok = store.load_score_batch(flat, qvecs, 4, norms, dots)
    np.testing.assert_array_equal(ok, ok_ref)
    ref_norms = np.einsum("ij,ij->i", vecs, vecs)
    ref_dots = np.einsum("ij,ij->i", vecs,
                         np.repeat(qvecs, 4, axis=0))
    np.testing.assert_allclose(norms[ok], ref_norms[ok], rtol=1e-6)
    np.testing.assert_allclose(dots[ok], ref_dots[ok], rtol=1e-5)
    # failed slots must be zeroed, not stale
    assert (norms[~ok] == 0).all() and (dots[~ok] == 0).all()


def test_load_score_batch_f16(tmp_path, rng):
    """Fused scoring over f16 ciphertext payloads: the C loop widens in
    L1 and scores the widened row."""
    km = KeyManager(str(tmp_path / "ks16.blob"))
    s = PointStore(str(tmp_path / "db16"), km, dim=8, dtype="f16")
    try:
        vecs = rng.normal(size=(16, 8)).astype(np.float32)
        s.insert_batch(np.arange(16), vecs)
        flat = np.arange(16, dtype=np.int64)
        qvecs = rng.normal(size=(4, 8)).astype(np.float32)
        got, ok_ref = s.load_decrypt_batch(flat)
        norms = np.zeros(16, np.float32)
        dots = np.zeros(16, np.float32)
        ok = s.load_score_batch(flat, qvecs, 4, norms, dots)
        assert ok.all() and ok_ref.all()
        np.testing.assert_allclose(
            norms, np.einsum("ij,ij->i", got, got), rtol=1e-6)
        np.testing.assert_allclose(
            dots, np.einsum("ij,ij->i", got, np.repeat(qvecs, 4, axis=0)),
            rtol=1e-5, atol=1e-5)
    finally:
        s.close()


def test_load_score_batch_f16_odd_dim(tmp_path, rng):
    """Odd dims make ct_len (= 2*dim) a non-multiple of 4: the fused f16
    score-only path must still widen into a float-ALIGNED scratch row
    (regression for the odd-offset reinterpret, aes_gcm.c wide_off)."""
    km = KeyManager(str(tmp_path / "ks7.blob"))
    s = PointStore(str(tmp_path / "db7"), km, dim=7, dtype="f16")
    try:
        vecs = rng.normal(size=(12, 7)).astype(np.float32)
        s.insert_batch(np.arange(12), vecs)
        flat = np.arange(12, dtype=np.int64)
        qvecs = rng.normal(size=(3, 7)).astype(np.float32)
        got, ok_ref = s.load_decrypt_batch(flat)
        norms = np.zeros(12, np.float32)
        dots = np.zeros(12, np.float32)
        ok = s.load_score_batch(flat, qvecs, 4, norms, dots)
        assert ok.all() and ok_ref.all()
        np.testing.assert_allclose(
            norms, np.einsum("ij,ij->i", got, got), rtol=1e-6)
        np.testing.assert_allclose(
            dots, np.einsum("ij,ij->i", got, np.repeat(qvecs, 4, axis=0)),
            rtol=1e-5, atol=1e-5)
    finally:
        s.close()


def test_load_score_batch_validates_qvecs(store, rng):
    """qvecs row count must cover every slot's query index — the C loop
    has no bounds check, so an inconsistent caller must fail in Python."""
    store.insert_batch(np.arange(8), rng.normal(size=(8, 8)).astype(np.float32))
    flat = np.arange(8, dtype=np.int64)
    norms = np.zeros(8, np.float32)
    dots = np.zeros(8, np.float32)
    q_ok = rng.normal(size=(2, 8)).astype(np.float32)
    assert store.load_score_batch(flat, q_ok, 4, norms, dots).all()
    with pytest.raises(ValueError):   # 1 query row covers only 4 slots
        store.load_score_batch(flat, q_ok[:1], 4, norms, dots)
    with pytest.raises(ValueError):   # wrong dim
        store.load_score_batch(flat, q_ok[:, :4], 4, norms, dots)
    with pytest.raises(ValueError):
        store.load_score_batch(flat, q_ok, 0, norms, dots)
