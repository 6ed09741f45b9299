"""AES-GCM kernel + keystore tests (reference crypto/ + keymanagement/ suites)."""

import os

import numpy as np
import pytest

from fspann.crypto import aesgcm
from fspann.crypto.keys import KeyManager


def test_nist_vectors():
    aesgcm.selftest()


def test_roundtrip_with_aad(rng):
    k = aesgcm.GcmKey(bytes(range(32)))
    iv = bytes(range(12))
    pt = rng.integers(0, 256, 1000).astype(np.uint8).tobytes()
    aad = b"id:42|v:3|d:128"
    sealed = k.seal(iv, pt, aad)
    assert len(sealed) == len(pt) + 16
    assert k.open(iv, sealed, aad) == pt
    # wrong AAD rejected (AAD binding, reference AesGcmCryptoServiceTest)
    with pytest.raises(ValueError):
        k.open(iv, sealed, b"id:43|v:3|d:128")
    # wrong key rejected
    k2 = aesgcm.GcmKey(bytes(range(1, 33)))
    with pytest.raises(ValueError):
        k2.open(iv, sealed, aad)
    # truncated/tampered ciphertext rejected
    with pytest.raises(ValueError):
        k.open(iv, sealed[:-1], aad)


def test_batch_multikey(rng):
    keys = [aesgcm.GcmKey(bytes([i]) * 32) for i in range(3)]
    n, reclen = 64, 40
    pt = rng.integers(0, 256, n * reclen).astype(np.uint8)
    offs = np.arange(n, dtype=np.uint64) * reclen
    lens = np.full(n, reclen, np.uint64)
    ivs = rng.integers(0, 256, (n, 12)).astype(np.uint8)
    aads = [f"r{i}".encode() for i in range(n)]
    key_idx = (np.arange(n) % 3).astype(np.uint32)
    # seal each record under its own key via the single-record path
    ct = np.empty_like(pt)
    tags = np.empty((n, 16), np.uint8)
    for i in range(n):
        sealed = keys[key_idx[i]].seal(ivs[i].tobytes(),
                                       pt[i * reclen:(i + 1) * reclen].tobytes(),
                                       aads[i])
        ct[i * reclen:(i + 1) * reclen] = np.frombuffer(sealed[:-16], np.uint8)
        tags[i] = np.frombuffer(sealed[-16:], np.uint8)
    dec, ok = aesgcm.open_batch(keys, key_idx, ivs, aads, ct, offs, lens, tags)
    assert ok.all()
    np.testing.assert_array_equal(dec, pt)
    # corrupt one tag -> only that record fails, output zeroed
    tags[5] ^= 1
    dec2, ok2 = aesgcm.open_batch(keys, key_idx, ivs, aads, ct, offs, lens, tags)
    assert not ok2[5] and ok2.sum() == n - 1
    assert not dec2[5 * reclen:(5 + 1) * reclen].any()


def test_seal_batch_matches_single(rng):
    k = aesgcm.GcmKey(b"\x07" * 32)
    n, reclen = 16, 24
    pt = rng.integers(0, 256, n * reclen).astype(np.uint8)
    offs = np.arange(n, dtype=np.uint64) * reclen
    lens = np.full(n, reclen, np.uint64)
    ivs = rng.integers(0, 256, (n, 12)).astype(np.uint8)
    aads = [f"a{i}".encode() for i in range(n)]
    ct, tags = aesgcm.seal_batch(k, ivs, aads, pt, offs, lens)
    for i in range(n):
        single = k.seal(ivs[i].tobytes(),
                        pt[i * reclen:(i + 1) * reclen].tobytes(), aads[i])
        assert ct[i * reclen:(i + 1) * reclen].tobytes() == single[:-16]
        assert tags[i].tobytes() == single[-16:]


# ---------------------------------------------------------------------------
# KeyManager (reference KeyManagerTest / KeyManagerPersistenceTest)
# ---------------------------------------------------------------------------

def test_key_derivation_deterministic(tmp_path):
    km = KeyManager(str(tmp_path / "ks.blob"))
    k1a = km.get_version(1).key
    km.rotate()
    k2 = km.get_version(2).key
    k1b = km.get_version(1).key
    assert k1a == k1b
    assert k1a != k2
    assert len(k1a) == 32


def test_keystore_survives_restart(tmp_path):
    path = str(tmp_path / "ks.blob")
    km = KeyManager(path)
    km.rotate(); km.rotate()
    k3 = km.get_version(3).key
    k1 = km.get_version(1).key
    km2 = KeyManager(path)
    assert km2.current_version == 3
    assert km2.get_version(3).key == k3
    assert km2.get_version(1).key == k1


def test_deleted_version_unrecoverable(tmp_path):
    path = str(tmp_path / "ks.blob")
    km = KeyManager(path)
    km.rotate(); km.rotate()
    km.delete_version(1)
    with pytest.raises(KeyError):
        km.get_version(1)
    # deletion persists across restart
    km2 = KeyManager(path)
    with pytest.raises(KeyError):
        km2.get_version(1)
    assert km2.live_versions() == [2, 3]


def test_cannot_delete_current(tmp_path):
    km = KeyManager(str(tmp_path / "ks.blob"))
    with pytest.raises(ValueError):
        km.delete_version(1)


def test_retention_window(tmp_path):
    km = KeyManager(str(tmp_path / "ks.blob"), retention_max=3)
    for _ in range(6):
        km.rotate()
    dropped = km.enforce_retention()
    assert dropped == [1, 2, 3, 4]
    assert km.live_versions() == [5, 6, 7]


def test_atomic_persist_no_partial(tmp_path):
    path = str(tmp_path / "ks.blob")
    km = KeyManager(path)
    km.rotate()
    # no .tmp left behind
    assert not os.path.exists(path + ".tmp")


def test_long_message_cross_check_vs_cryptography_lib():
    """Byte-exact agreement with an independent AES-GCM implementation at
    lengths that exercise the VAES 256B-bulk path, the SSE 128B path, and
    the block/partial tails (NIST vectors alone are too short to cover the
    wide path)."""
    pytest.importorskip("cryptography")
    import secrets
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    from fspann.crypto.aesgcm import GcmKey

    rng = np.random.default_rng(0)
    for length in (16, 255, 256, 257, 512, 528, 1000, 4096):
        key = secrets.token_bytes(32)
        iv = secrets.token_bytes(12)
        aad = secrets.token_bytes(32)
        pt = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
        ours = GcmKey(key).seal(iv, pt, aad)
        ref = AESGCM(key).encrypt(iv, pt, aad)
        assert ours == ref, f"seal mismatch at len {length}"
        assert GcmKey(key).open(iv, ref, aad) == pt


def test_multithreaded_batch_open_identical(tmp_path, monkeypatch):
    """FSPANN_THREADS splits the batch across pthreads with disjoint output
    ranges — results must be bit-identical to single-threaded, including
    per-record failures."""
    import secrets
    from fspann.store.point_store import PointStore

    km = KeyManager(str(tmp_path / "ks.blob"))
    s = PointStore(str(tmp_path / "db"), km, dim=16)
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(3000, 16)).astype(np.float32)
    s.insert_batch(np.arange(3000), vecs)
    ids = rng.integers(-5, 3100, 4000)       # includes missing/negative
    v1, ok1 = s.load_decrypt_batch(ids)
    monkeypatch.setenv("FSPANN_THREADS", "3")
    v2, ok2 = s.load_decrypt_batch(ids)
    np.testing.assert_array_equal(ok1, ok2)
    np.testing.assert_array_equal(v1, v2)
    norms = np.zeros(len(ids), np.float32)
    v3, ok3 = s.load_decrypt_batch(ids, norms_out=norms)
    np.testing.assert_allclose(
        norms[ok3], np.einsum("ij,ij->i", v3[ok3], v3[ok3]), rtol=1e-5)
    s.close()
