"""i8 ciphertext storage: roundtrip, requant idempotence, fused scoring,
re-encryption drift, E2E recall + restore determinism.

The i8 payload is symmetric per-row int8 with an f32 scale prefix riding
INSIDE the sealed ciphertext ([scale][dim x int8], v_j = scale * q_j) — 4x
less arena traffic than f32 on a DRAM-bandwidth-bound serving host.
Reference parity: the reference stores f64 plaintext bytes
(crypto/AesGcmCryptoService.java:72-83); quantized payloads are a
beyond-reference storage option, ARCHITECTURE.md "storage dtypes".
"""

import numpy as np

from fspann.api.system import ForwardSecureANNSystem
from fspann.config import (EvalConfig, PaperConfig, RuntimeConfig,
                               SystemConfig)
from fspann.crypto.keys import KeyManager
from fspann.io import groundtruth
from fspann.store.point_store import PointStore

DIM = 16


def i8_cfg():
    return SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=600, max_global_candidates=600,
                              block_size=32, storage_dtype="i8"),
        eval=EvalConfig(k_variants=(1, 10)),
    ).validate()


def test_store_i8_roundtrip(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks"))
    s = PointStore(str(tmp_path / "db"), km, dim=8, dtype="i8")
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    vq = s.quantize(vecs)
    s.insert_batch(np.arange(50), vecs)
    out, ok = s.load_decrypt_batch(np.arange(50))
    assert ok.all()
    np.testing.assert_array_equal(out, vq)     # exact dequant roundtrip
    # per-row relative error bound: |err| <= 0.5 * scale = max|v| / 254
    amax = np.abs(vecs).max(axis=1, keepdims=True)
    assert (np.abs(out - vecs) <= amax / 254 + 1e-7).all()
    # record is (dim + 4 scale bytes) + tag
    assert s.record_ct_len == 8 + 4 + 16
    s.close()


def test_i8_requantization_idempotent(tmp_path, rng):
    """quantize(quantize(v)) == quantize(v): the row max maps to +-127
    exactly, so a re-encryption sweep (decrypt -> insert under a new key)
    cannot drift the stored values, no matter how many rotations run."""
    km = KeyManager(str(tmp_path / "ks"))
    s = PointStore(str(tmp_path / "db"), km, dim=24, dtype="i8")
    vecs = rng.normal(size=(200, 24)).astype(np.float32) * \
        rng.uniform(0.01, 100, size=(200, 1)).astype(np.float32)
    vecs[0] = 0.0                               # all-zero row: scale 0
    once = s.quantize(vecs)
    np.testing.assert_array_equal(s.quantize(once), once)

    # end-to-end: three re-encryption sweeps leave the payload bit-stable
    s.insert_batch(np.arange(200), vecs)
    first, ok = s.load_decrypt_batch(np.arange(200))
    assert ok.all()
    for _ in range(3):
        km.rotate()
        rep = s.reencrypt_all()
        assert rep.failed == 0
    final, ok = s.load_decrypt_batch(np.arange(200))
    assert ok.all()
    np.testing.assert_array_equal(final, first)
    s.close()


def test_i8_fused_norms_and_dots_match(tmp_path, rng):
    """The C loop's fused int8 dequant + norm/dot accumulation (norm =
    s^2 * sum q^2 over int64, dot = s * sum q*qv) matches a recompute,
    including the scalar tail at odd dims and zeroed missing-id slots."""
    dim = 19                                    # odd: exercises tail loop
    km = KeyManager(str(tmp_path / "ksn"))
    store = PointStore(str(tmp_path / "dbn"), km, dim=dim, dtype="i8")
    vecs = (rng.normal(size=(64, dim)) * 8).astype(np.float32)
    vecs[3, :4] = [0.0, 1e-4, -1e-4, 3.14159]
    store.insert_batch(np.arange(64), vecs)
    vq = store.quantize(vecs)

    ids = np.concatenate([np.arange(64), [999]])   # one missing id
    norms = np.zeros(len(ids), np.float32)
    got, ok = store.load_decrypt_batch(ids, norms_out=norms)
    assert ok[:64].all() and not ok[64]
    np.testing.assert_array_equal(got[:64], vq)
    np.testing.assert_allclose(norms[:64], (vq * vq).sum(axis=1), rtol=1e-5)
    assert (got[64] == 0).all() and norms[64] == 0

    # fused decrypt-and-score: plaintext never reaches DRAM
    qvecs = rng.normal(size=(5, dim)).astype(np.float32)
    n = 65
    rows_per_query = 13
    norms2 = np.zeros(n, np.float32)
    dots2 = np.zeros(n, np.float32)
    ok2 = store.load_score_batch(ids, qvecs, rows_per_query, norms2, dots2)
    assert ok2[:64].all() and not ok2[64]
    np.testing.assert_allclose(norms2[:64], (vq * vq).sum(axis=1), rtol=1e-5)
    want_dots = np.einsum("ij,ij->i", vq,
                          qvecs[np.arange(64) // rows_per_query])
    np.testing.assert_allclose(dots2[:64], want_dots, rtol=1e-4, atol=1e-4)
    assert norms2[64] == 0 and dots2[64] == 0
    store.close()


def test_insert_prequant_matches_plain(tmp_path, rng):
    """quantize_parts + insert_batch(prequant=) (the single-quantization
    ingest path) stores byte-identical payloads to the plain path."""
    km = KeyManager(str(tmp_path / "ks"))
    a = PointStore(str(tmp_path / "a"), km, dim=12, dtype="i8")
    b = PointStore(str(tmp_path / "b"), km, dim=12, dtype="i8")
    vecs = (rng.normal(size=(40, 12)) * 7).astype(np.float32)
    preview, parts = a.quantize_parts(vecs)
    assert parts is not None
    np.testing.assert_array_equal(preview, a.quantize(vecs))
    a.insert_batch(np.arange(40), preview, prequant=parts)
    b.insert_batch(np.arange(40), vecs)
    va, oka = a.load_decrypt_batch(np.arange(40))
    vb, okb = b.load_decrypt_batch(np.arange(40))
    assert oka.all() and okb.all()
    np.testing.assert_array_equal(va, vb)
    # f32/f16 stores have no parts (their round trip is a cast)
    c = PointStore(str(tmp_path / "c"), km, dim=12, dtype="f32")
    _, none_parts = c.quantize_parts(vecs)
    assert none_parts is None
    # mismatched prequant shapes fail loudly
    try:
        a.insert_batch(np.arange(3), preview[:3], prequant=parts)
        raise AssertionError("expected ValueError")
    except ValueError:
        pass
    for s in (a, b, c):
        s.close()


def test_open_wrong_dtype_fails_loudly(tmp_path, rng):
    """Reopening an arena under a different storage dtype must raise at
    open time: record lengths are dtype-derived, so a mismatched open
    would read every GCM tag at the wrong offset and fail each decrypt
    SILENTLY (ok=False rows -> garbage results with no error anywhere)."""
    km = KeyManager(str(tmp_path / "ks"))
    s = PointStore(str(tmp_path / "db"), km, dim=8, dtype="f32")
    s.insert_batch(np.arange(10), rng.normal(size=(10, 8)).astype(np.float32))
    s.close()
    for wrong in ("f16", "i8"):
        try:
            PointStore(str(tmp_path / "db"), km, dim=8, dtype=wrong)
            raise AssertionError(f"expected ValueError opening as {wrong}")
        except ValueError as e:
            assert "storage dtype" in str(e)
    # the matching dtype (and an empty store under any dtype) opens fine
    s = PointStore(str(tmp_path / "db"), km, dim=8, dtype="f32")
    _, ok = s.load_decrypt_batch(np.arange(10))
    assert ok.all()
    s.close()
    PointStore(str(tmp_path / "empty"), km, dim=8, dtype="i8").close()


def test_dtype_marker_catches_length_collision(tmp_path, rng):
    """At dim=4 the f16 body (2*4=8B) equals the i8 body (4+4=8B), so the
    record-length check passes and every GCM open would succeed under the
    wrong payload interpretation (same key/IV/AAD) — the first 4 f16 bytes
    silently decoded as the i8 scale.  The persisted storage-dtype marker
    must catch exactly this case."""
    km = KeyManager(str(tmp_path / "ks"))
    s = PointStore(str(tmp_path / "db"), km, dim=4, dtype="f16")
    s.insert_batch(np.arange(6), rng.normal(size=(6, 4)).astype(np.float32))
    s.close()
    try:
        PointStore(str(tmp_path / "db"), km, dim=4, dtype="i8")
        raise AssertionError("expected ValueError opening f16 store as i8")
    except ValueError as e:
        assert "storage dtype" in str(e) and "'f16'" in str(e)
    # legacy stores (no marker) adopt the configured dtype on first open
    # after the geometry check passes
    import os
    os.remove(str(tmp_path / "db" / "points" / "storage_dtype"))
    s = PointStore(str(tmp_path / "db"), km, dim=4, dtype="f16")
    _, ok = s.load_decrypt_batch(np.arange(6))
    assert ok.all()
    s.close()
    with open(str(tmp_path / "db" / "points" / "storage_dtype")) as f:
        assert f.read().strip() == "f16"


def test_i8_e2e_recall_and_restore(tmp_path, rng):
    centers = rng.normal(size=(16, DIM)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, 1500)] + \
        rng.normal(size=(1500, DIM)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 10)] + \
        rng.normal(size=(10, DIM)).astype(np.float32)

    sys1 = ForwardSecureANNSystem(i8_cfg(), str(tmp_path / "db"), DIM,
                                  query_batch=8)
    sys1.index_stream(base, batch_size=500)
    sys1.finalize_for_search()
    gtm = groundtruth.precompute(base, queries, k=10)
    agg = sys1.run_queries(queries, gtm, base)
    assert agg.recall_at_k[10] > 0.9
    assert agg.ratio_at_k[10] < 1.05
    tok = sys1.create_token(queries[0], 10)
    res1 = sys1.search(tok)
    sys1.shutdown()

    # restore determinism holds because staging quantized through i8
    sys2 = ForwardSecureANNSystem(i8_cfg(), str(tmp_path / "db"), DIM,
                                  query_batch=8)
    try:
        assert sys2.restore_index_from_disk() == 1500
        res2 = sys2.search(sys2.create_token(queries[0], 10))
        assert [r.id for r in res1] == [r.id for r in res2]
    finally:
        sys2.shutdown()


def test_mesh_i8_scan_recall_and_stream_equality(tmp_path, rng):
    """DistributedEncryptedSystem with i8 payloads: the mesh quantizes
    through the storage dtype BEFORE encoding (codes match what decrypt
    decodes), serving recall holds, and streamed build == one-shot build."""
    import jax
    import pytest
    from fspann.parallel.serving import DistributedEncryptedSystem
    if len(jax.devices()) < 2:
        pytest.skip("needs multi-device mesh")

    n, d, q, k = 2048, 16, 6, 10
    centers = rng.normal(size=(16, d)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    cfg = SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=600, max_global_candidates=600,
                              block_size=32, routing_mode="scan",
                              storage_dtype="i8")).validate()
    s1 = DistributedEncryptedSystem(cfg, str(tmp_path / "one"), d)
    s2 = DistributedEncryptedSystem(cfg, str(tmp_path / "str"), d)
    try:
        assert s1.store.dtype == "i8"
        s1.build(base)
        ids, dists = s1.search_batch(queries, k)
        d2 = ((base[None] - queries[:, None]) ** 2).sum(-1)
        gt = np.argsort(d2, axis=1)[:, :k]
        hits = sum(len(set(ids[i]) & set(gt[i])) for i in range(q))
        assert hits / (q * k) > 0.9

        # streamed build must reproduce the one-shot results bit-exactly
        s2.index_stream((base[s:s + 512] for s in range(0, n, 512)),
                        n_total=n)
        ids2, dists2 = s2.search_batch(queries, k)
        np.testing.assert_array_equal(ids, ids2)
        np.testing.assert_allclose(dists, dists2, rtol=1e-6)
    finally:
        s1.close()
        s2.close()
