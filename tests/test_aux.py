"""Auxiliary subsystem tests: caches, metrics, diagnostics, sharded store,
key utils (reference common/ + api/ auxiliary suites)."""

import time

import numpy as np
import pytest

from fspann.crypto.keys import KeyManager
from fspann.crypto.keyutils import key_from_bytes, try_decrypt
from fspann.query.diagnostics import QueryDiagnostics
from fspann.store.sharded_store import ShardedPointStore
from fspann.utils.cache import ExpiringCache, LRUCache
from fspann.utils.metrics import MetricsRegistry
from fspann.utils.storage_metrics import StorageMetrics


def test_lru_cache():
    c = LRUCache(2)
    c.put("a", 1); c.put("b", 2)
    assert c.get("a") == 1          # refresh a
    c.put("c", 3)                   # evicts b
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3


def test_expiring_cache():
    c = ExpiringCache(capacity=4, ttl_s=0.05)
    c.put("k", "v")
    assert c.get("k") == "v"
    time.sleep(0.06)
    assert c.get("k") is None
    assert c.hits == 1 and c.misses == 1


def test_metrics_registry():
    m = MetricsRegistry()
    m.count("x"); m.count("x", 2)
    for v in range(100):
        m.record("lat", float(v))
    with m.timer("t"):
        pass
    text = m.export_text()
    assert "counter x 3" in text
    assert m.summaries["lat"].mean == pytest.approx(49.5)
    assert m.summaries["lat"].percentile(95) >= 90
    assert "summary t" in text


def test_query_diagnostics_worst_heap():
    d = QueryDiagnostics(worst_capacity=3)
    recalls = [0.9, 0.1, 0.5, 0.0, 0.8, 0.2]
    for i, r in enumerate(recalls):
        d.record(i, r, [1, 2], [0.1, 0.2], [1, 3])
    worst = d.worst()
    assert [(-e.recall) for e in worst] == [0.0, 0.1, 0.2]
    assert d.zero_hit_queries == [3]
    assert d.summary()["worst_recall"] == pytest.approx(0.2)


def test_query_diagnostics_csv(tmp_path):
    d = QueryDiagnostics()
    d.record(0, 0.5, [1], [1.0], [2])
    p = str(tmp_path / "qd.csv")
    d.export_csv(p)
    assert "query_index" in open(p).read()


def test_storage_metrics(tmp_path):
    base = tmp_path / "db"
    (base / "points").mkdir(parents=True)
    (base / "points" / "v1.arena").write_bytes(b"x" * 1000)
    (base / "meta.log").write_bytes(b"y" * 100)
    sm = StorageMetrics(str(base))
    snap = sm.snapshot()
    assert snap.points_bytes == 1000
    assert snap.metadata_bytes == 100
    assert snap.total_bytes == 1100
    # cached within TTL even if file grows
    (base / "points" / "v1.arena").write_bytes(b"x" * 2000)
    assert sm.snapshot().points_bytes == 1000
    assert sm.snapshot(force=True).points_bytes == 2000


def test_sharded_store_roundtrip(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks"))
    s = ShardedPointStore(str(tmp_path / "db"), km, dim=8, num_shards=3)
    ids = np.arange(100)
    vecs = rng.normal(size=(100, 8)).astype(np.float32)
    s.insert_batch(ids, vecs)
    # data actually spread across shards
    sizes = [len(sh.meta) for sh in s.shards]
    assert all(sz > 0 for sz in sizes) and sum(sizes) == 100
    out, ok = s.load_decrypt_batch(np.array([5, 50, 99, -1]))
    assert ok.tolist() == [True, True, True, False]
    np.testing.assert_allclose(out[0], vecs[5], rtol=1e-6)
    s.delete([5])
    _, ok2 = s.load_decrypt_batch(np.array([5]))
    assert not ok2[0]
    # rotation + selective re-encryption across shards
    km.rotate()
    rep = s.reencrypt_ids(np.arange(50))
    assert rep.reencrypted == 49   # id 5 deleted
    assert s.count_with_version(2) == 49
    s.close()


def test_sharded_store_range_placement(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks"))
    s = ShardedPointStore(str(tmp_path / "db"), km, dim=4, num_shards=4,
                          placement="range")
    s.set_range_size(25)
    ids = np.arange(100)
    s.insert_batch(ids, rng.normal(size=(100, 4)).astype(np.float32))
    assert all(len(sh.meta) == 25 for sh in s.shards)
    s.close()


def test_keyutils(rng):
    kv = key_from_bytes(bytes(range(32)), version=7)
    assert kv.version == 7
    gcm = kv.gcm()
    ct = gcm.seal(b"\x00" * 12, b"hello", b"aad1")
    assert try_decrypt(bytes(range(32)), b"\x00" * 12, ct,
                       [b"wrong", b"aad1"]) == b"hello"
    assert try_decrypt(bytes(range(1, 33)), b"\x00" * 12, ct,
                       [b"aad1"]) is None


def test_sharded_store_retire_version_visits_every_shard(tmp_path, rng):
    """retire_version must attempt retirement on ALL shards even when an
    early shard still holds live points at the version — an all(generator)
    short-circuit left later eligible shards unretired (review finding)."""
    import os

    from fspann.crypto.keys import KeyManager
    km = KeyManager(str(tmp_path / "ks.blob"))
    s = ShardedPointStore(str(tmp_path / "db"), km, dim=8, num_shards=3)
    ids = np.arange(60)
    s.insert_batch(ids, rng.normal(size=(60, 8)).astype(np.float32))
    shard = s.shard_of(ids)
    assert all((shard == i).any() for i in range(3))
    km.rotate()
    # migrate everything OFF v1 except shard 1's points
    s.reencrypt_ids(ids[shard != 1])
    retired = s.retire_version(1)
    assert not retired   # shard 1 still owns live v1 points
    assert not os.path.exists(s.shards[0]._arena_path(1))
    assert not os.path.exists(s.shards[2]._arena_path(1))
    assert os.path.exists(s.shards[1]._arena_path(1))
    # after shard 1 migrates, retirement completes everywhere
    s.reencrypt_ids(ids[shard == 1])
    assert s.retire_version(1)
    assert not os.path.exists(s.shards[1]._arena_path(1))
    s.close()


def test_sharded_store_probe_shards(tmp_path, rng):
    from fspann.crypto.keys import KeyManager
    km = KeyManager(str(tmp_path / "ks.blob"))
    s = ShardedPointStore(str(tmp_path / "db"), km, dim=8, num_shards=4)
    vecs = rng.normal(size=(64, 8)).astype(np.float32)
    s.insert_batch(np.arange(64), vecs)
    full_v, full_ok = s.load_decrypt_batch(np.arange(64))
    assert full_ok.all()
    sub_v, sub_ok = s.load_decrypt_batch(np.arange(64), probe_shards=2)
    shard = s.shard_of(np.arange(64))
    assert sub_ok.sum() == (shard < 2).sum()
    assert (sub_ok == (shard < 2)).all()
    np.testing.assert_allclose(sub_v[sub_ok], vecs[sub_ok], rtol=1e-6)
    s.close()
