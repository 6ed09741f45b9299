"""Forward-security games G1–G6 (reference
it/src/test/java/com/fspann/it/adversarial/ForwardSecurityGameTest.java).

The adversary snapshots a session key, then the system rotates and
selectively re-encrypts.  Games assert the snapshot is useless against
migrated ciphertexts, ciphertexts are indistinguishable across rotation,
selective re-encryption touches only the touched set, usage accounting is
exact, and deletion is blocked while ciphertexts remain bound.
"""

import numpy as np
import pytest

from fspann.crypto import aesgcm
from fspann.crypto.keys import KeyManager
from fspann.crypto.rotation import (BackgroundReencryption,
                                        KeyRotationService, ReencryptionTracker,
                                        RotationPolicy)
from fspann.store.point_store import PointStore
from fspann.types import aad_for


@pytest.fixture
def system(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks.blob"))
    store = PointStore(str(tmp_path / "db"), km, dim=8)
    svc = KeyRotationService(km, store)
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    store.insert_batch(np.arange(50), vecs)
    yield km, store, svc, vecs
    store.close()


def _raw_record(store, pid):
    m = store.meta.get(pid)
    reader = store._reader(m.key_version)
    rid, rkv, dim, iv, ct = reader.read_record(m.arena_off)
    assert rid == pid
    return rkv, iv, ct


def test_g1_old_key_fails_on_reencrypted(system):
    """G1: compromised old key decrypts 0 re-encrypted points (ref :174-203)."""
    km, store, svc, vecs = system
    stolen = aesgcm.GcmKey(km.get_version(1).key)   # adversary snapshot
    svc.force_rotate_now()
    store.reencrypt_ids(list(range(50)))
    decrypted = 0
    for pid in range(50):
        kv, iv, ct = _raw_record(store, pid)
        assert kv == 2
        for aad_v in (1, 2):   # adversary tries both AAD versions
            try:
                stolen.open(iv, ct, aad_for(pid, aad_v, 8))
                decrypted += 1
            except ValueError:
                pass
    assert decrypted == 0


def test_g2_ciphertext_indistinguishable_across_rotation(system):
    """G2: re-encryption produces fresh IVs and unrelated ciphertext bytes
    (ref :206-230)."""
    km, store, svc, vecs = system
    before = {pid: _raw_record(store, pid) for pid in range(50)}
    svc.force_rotate_now()
    store.reencrypt_ids(list(range(50)))
    for pid in range(50):
        kv0, iv0, ct0 = before[pid]
        kv1, iv1, ct1 = _raw_record(store, pid)
        assert iv0 != iv1
        assert ct0 != ct1
        # same plaintext underneath
    out, ok = store.load_decrypt_batch(np.arange(50))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)


def test_g3_selective_touches_only_touched(system):
    """G3: selective re-encryption migrates exactly the touched set
    (ref :233-267)."""
    km, store, svc, vecs = system
    svc.force_rotate_now()
    tracker = ReencryptionTracker()
    tracker.record([17])
    report = svc.reencrypt_touched(tracker.drain())
    assert report.reencrypted == 1
    assert store.key_version_of(17) == 2
    for pid in range(50):
        if pid != 17:
            assert store.key_version_of(pid) == 1


def test_g4_usage_accounting_exact(system):
    """G4: per-version binding counts are exact (ref :270-299)."""
    km, store, svc, _ = system
    assert store.meta.count_with_version(1) == 50
    svc.force_rotate_now()
    store.reencrypt_ids([0, 1, 2])
    assert store.meta.count_with_version(1) == 47
    assert store.meta.count_with_version(2) == 3
    store.delete([0, 5])
    assert store.meta.count_with_version(2) == 2
    assert store.meta.count_with_version(1) == 46


def test_g5_safe_deletion_soundness(system):
    """G5: key deletion is blocked while any ciphertext is bound; allowed and
    irreversible after full migration (ref :302-327)."""
    km, store, svc, vecs = system
    svc.force_rotate_now()
    assert not svc.is_safe_to_delete(1)          # 50 points still on v1
    assert svc.finalize_rotation() == []         # refuses
    store.reencrypt_ids(list(range(50)))
    assert svc.is_safe_to_delete(1)
    svc.force_rotate_now()                        # current=3 so v1 < current-1
    dropped = svc.finalize_rotation()
    assert dropped == [1]
    with pytest.raises(KeyError):
        km.get_version(1)
    # arena retired with the key
    import os
    assert not os.path.exists(store._arena_path(1))
    out, ok = store.load_decrypt_batch(np.arange(50))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)


def test_g6_correctness_preserved_under_rotation(system):
    """G6: decrypt-side correctness across repeated rotation + partial
    migration (reference ForwardSecurityGame_G6_Test)."""
    km, store, svc, vecs = system
    for round_ in range(3):
        svc.force_rotate_now()
        store.reencrypt_ids(list(range(round_ * 10, round_ * 10 + 10)))
        out, ok = store.load_decrypt_batch(np.arange(50))
        assert ok.all()
        np.testing.assert_allclose(out, vecs, rtol=1e-6)


def test_rotation_policy_thresholds(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks.blob"))
    store = PointStore(str(tmp_path / "db"), km, dim=8)
    svc = KeyRotationService(km, store,
                             RotationPolicy(max_operations=10))
    assert not svc.rotate_if_needed()
    svc.track_operations(10)
    assert svc.rotate_if_needed()
    assert km.current_version == 2
    # pinned version blocks rotation (query-only restore)
    svc.activate_version(2)
    svc.track_operations(100)
    assert not svc.rotate_if_needed()
    store.close()


def test_background_reencryption(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks.blob"))
    store = PointStore(str(tmp_path / "db"), km, dim=8)
    svc = KeyRotationService(km, store)
    store.insert_batch(np.arange(30), rng.normal(size=(30, 8)).astype(np.float32))
    svc.force_rotate_now()
    bg = BackgroundReencryption(svc, batch=10)
    moved = bg.run_once()
    assert moved == 10
    assert store.meta.count_with_version(2) == 10
    bg.run_once(); bg.run_once()
    assert store.meta.count_with_version(1) == 0
    assert bg.run_once() == 0   # nothing stale left
    store.close()


def test_background_reencryption_under_live_queries(tmp_path, rng):
    """Soak: the background migrator runs concurrently with live decrypt
    batches; every read stays consistent and migration completes
    (reference BackgroundReencryptionScheduler's raison d'etre)."""
    import threading

    km = KeyManager(str(tmp_path / "ks.blob"))
    store = PointStore(str(tmp_path / "db"), km, dim=8)
    svc = KeyRotationService(km, store)
    vecs = rng.normal(size=(400, 8)).astype(np.float32)
    store.insert_batch(np.arange(400), vecs)
    svc.force_rotate_now()

    bg = BackgroundReencryption(svc, interval_s=0.01, batch=50,
                                load_shed_qps=1e9)
    errors = []

    def reader():
        for _ in range(30):
            out, ok = store.load_decrypt_batch(
                rng.integers(0, 400, 64))
            if not ok.all():
                errors.append("decrypt failure during migration")
                return

    t = threading.Thread(target=reader)
    bg.start()
    t.start()
    t.join()
    # let migration finish
    for _ in range(20):
        if store.meta.count_with_version(1) == 0:
            break
        bg.run_once()
    bg.stop()
    assert not errors, errors
    assert store.meta.count_with_version(1) == 0
    out, ok = store.load_decrypt_batch(np.arange(400))
    assert ok.all()
    np.testing.assert_allclose(out, vecs, rtol=1e-6)
    store.close()


def test_g1_prime_stolen_keystore_cannot_rederive_deleted(system, tmp_path):
    """G1': the adversary steals the CURRENT keystore blob plus an OLD arena
    snapshot.  The reference fails this game — its blob persists one fixed
    master that re-derives every 'deleted' session key (KeyManager.java:
    221-237).  Here the master is a hash ratchet: finalizing v1 advances the
    persisted chain head past it, so the stolen blob (a) refuses v1 via the
    API, (b) holds master bytes DIFFERENT from those v1's key was derived
    from, and (c) none of the keys it CAN derive open the old arena record."""
    import shutil

    km, store, svc, vecs = system
    # snapshot what the adversary will steal later: v1's arena bytes
    store.flush()
    arena_snapshot = tmp_path / "stolen_v1.arena"
    shutil.copy(store._arena_path(1), arena_snapshot)
    blob_before = open(km.store_path, "rb").read()
    k1 = km.get_version(1).key

    # full migration off v1, then finalize (securely deletes v1)
    svc.force_rotate_now()
    store.reencrypt_ids(list(range(50)))
    svc.force_rotate_now()
    assert svc.finalize_rotation() == [1]

    # the persisted master actually changed (ratchet advanced)
    blob_after = open(km.store_path, "rb").read()
    assert blob_before[-32:] != blob_after[-32:]

    # adversary loads the stolen blob fresh
    stolen_path = tmp_path / "stolen.blob"
    shutil.copy(km.store_path, stolen_path)
    adv = KeyManager(str(stolen_path))
    assert adv.epoch_base == 2
    with pytest.raises(KeyError):
        adv.get_version(1)
    # keys the stolen blob CAN derive serve live data (it's the real
    # keystore) but none of them is v1's key ...
    for v in adv.live_versions():
        assert adv.get_version(v).key != k1
    # ... and none opens the old arena snapshot under the true AAD
    from fspann.store.arena import ArenaReader
    reader = ArenaReader(str(arena_snapshot))
    pid, rkv, dim, iv, ct = reader.read_record(0)
    assert rkv == 1
    opened = 0
    for v in adv.live_versions():
        for aad_v in (1, v):
            try:
                adv.gcm_for(v).open(iv, ct, aad_for(pid, aad_v, dim))
                opened += 1
            except ValueError:
                pass
    reader.close()
    assert opened == 0
    # sanity: the ORIGINAL v1 key does open the snapshot (the game is real)
    assert aesgcm.GcmKey(k1).open(iv, ct, aad_for(pid, 1, dim)) is not None


def test_ratchet_restore_equality_and_legacy_format(tmp_path):
    """Ratcheted keystores persist/load to identical keys; format-1 blobs
    (reference-compatible fixed master) still load and derive old-style."""
    import hashlib
    import hmac as hmac_mod
    import struct as struct_mod

    km = KeyManager(str(tmp_path / "ks.blob"))
    km.rotate()
    km.rotate()                     # v3 current
    keys = {v: km.get_version(v).key for v in (1, 2, 3)}
    km2 = KeyManager(str(tmp_path / "ks.blob"))
    for v in (1, 2, 3):
        assert km2.get_version(v).key == keys[v]
    km.delete_version(1)            # ratchet: base -> 2
    km3 = KeyManager(str(tmp_path / "ks.blob"))
    assert km3.epoch_base == 2
    for v in (2, 3):
        assert km3.get_version(v).key == keys[v]

    # hand-write a format-1 (legacy) blob and check old-style derivation
    master = b"\x07" * 32
    blob = b"FSPKS1\n" + struct_mod.pack(">iqd", 1, 2, 0.0) \
        + struct_mod.pack(">i", 0) + master
    p = tmp_path / "legacy.blob"
    p.write_bytes(blob)
    leg = KeyManager(str(p))
    assert leg._legacy
    want = hmac_mod.new(master, struct_mod.pack(">i", 2),
                        hashlib.sha256).digest()[:32]
    assert leg.get_version(2).key == want
    # legacy blobs persist back as format 1 (derivation must not change
    # under the adversary's nose)
    leg.persist()
    assert KeyManager(str(p))._legacy
