"""f16 ciphertext storage: roundtrip, restore determinism, E2E recall."""

import numpy as np

from fspann.api.system import ForwardSecureANNSystem
from fspann.config import (EvalConfig, PaperConfig, RuntimeConfig,
                               SystemConfig)
from fspann.crypto.keys import KeyManager
from fspann.io import groundtruth
from fspann.store.point_store import PointStore

DIM = 16


def f16_cfg():
    return SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=600, max_global_candidates=600,
                              block_size=32, storage_dtype="f16"),
        eval=EvalConfig(k_variants=(1, 10)),
    ).validate()


def test_store_f16_roundtrip(tmp_path, rng):
    km = KeyManager(str(tmp_path / "ks"))
    s = PointStore(str(tmp_path / "db"), km, dim=8, dtype="f16")
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    vq = s.quantize(vecs)
    s.insert_batch(np.arange(50), vecs)
    out, ok = s.load_decrypt_batch(np.arange(50))
    assert ok.all()
    np.testing.assert_array_equal(out, vq)     # exact f16 roundtrip
    assert np.abs(out - vecs).max() < 2e-3     # quantization error small
    # record is half the size of f32
    assert s.record_ct_len == 2 * 8 + 16
    s.close()


def test_f16_e2e_recall_and_restore(tmp_path, rng):
    centers = rng.normal(size=(16, DIM)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, 1500)] + \
        rng.normal(size=(1500, DIM)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 10)] + \
        rng.normal(size=(10, DIM)).astype(np.float32)

    sys1 = ForwardSecureANNSystem(f16_cfg(), str(tmp_path / "db"), DIM,
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

    # restore determinism holds because staging quantized through f16
    sys2 = ForwardSecureANNSystem(f16_cfg(), str(tmp_path / "db"), DIM,
                                  query_batch=8)
    try:
        assert sys2.restore_index_from_disk() == 1500
        res2 = sys2.search(sys2.create_token(queries[0], 10))
        assert [r.id for r in res1] == [r.id for r in res2]
    finally:
        sys2.shutdown()


def test_f16_fused_norms_match_numpy(tmp_path, rng):
    """The C loop's fused f16->f32 widen + norm accumulation matches a
    numpy recompute (covers both the F16C and scalar conversion paths,
    incl. zero rows for missing ids)."""
    km = KeyManager(str(tmp_path / "ksn"))
    store = PointStore(str(tmp_path / "dbn"), km, dim=DIM, dtype="f16")
    vecs = (rng.normal(size=(64, DIM)) * 8).astype(np.float32)
    vecs[3, :4] = [0.0, 1e-4, -1e-4, 3.14159]   # exercise tiny halves
    store.insert_batch(np.arange(64), vecs)
    ids = np.concatenate([np.arange(64), [999]])   # one missing id
    norms = np.zeros(len(ids), np.float32)
    got, ok = store.load_decrypt_batch(ids, norms_out=norms)
    assert ok[:64].all() and not ok[64]
    q = vecs.astype(np.float16).astype(np.float32)
    np.testing.assert_allclose(got[:64], q, rtol=0, atol=0)
    np.testing.assert_allclose(norms[:64], (q * q).sum(axis=1),
                               rtol=1e-5)
    assert (got[64] == 0).all()
    store.close()
