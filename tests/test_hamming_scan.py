"""Hamming scan (ops/hamming_scan.py): oracle + system-level tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from fspann.ops import coding, hamming_scan


def _mk(rng, n=500, d=24, m=10, lam=2, tables=2, divisions=2, seed=3):
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    bank = coding.build_bank_from_sample(base[:256], m, lam, tables,
                                         divisions, seed)
    codes, keys = coding.encode(jnp.asarray(base), bank)
    return base, bank, np.asarray(codes)


def test_unpack_bits_msb_first(rng):
    base, bank, codes = _mk(rng)
    bits = hamming_scan.unpack_bits_numpy(codes, bank.code_bits)
    n, g, w = codes.shape
    assert bits.shape == (n, g * bank.code_bits)
    # manual extraction (same convention as tests/test_routing.py oracles)
    for i in (0, 7, n - 1):
        for gi in range(g):
            for p in range(bank.code_bits):
                want = (codes[i, gi, p // 32] >> np.uint32(31 - p % 32)) & 1
                got = bits[i, gi * bank.code_bits + p]
                assert got == want, (i, gi, p)


def test_scan_exact_matches_numpy_oracle(rng):
    base, bank, codes = _mk(rng, n=400)
    queries = rng.normal(size=(9, 24)).astype(np.float32) * 4
    qc, _ = coding.encode(jnp.asarray(queries), bank)
    qbits = hamming_scan.unpack_bits_numpy(np.asarray(qc), bank.code_bits)
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    limit = 50
    res = hamming_scan.scan(state, jnp.asarray(qbits),
                            jnp.zeros(400, bool), limit, approx=False)
    bits = hamming_scan.unpack_bits_numpy(codes, bank.code_bits)
    for qi in range(9):
        fine = np.bitwise_xor(bits, qbits[qi]).sum(axis=1)
        exp = sorted(range(400), key=lambda c: (fine[c], c))[:limit]
        got = [int(x) for x in np.asarray(res.ids[qi])]
        assert got == exp, f"q={qi}"
        got_sc = [int(s) for s in np.asarray(res.scores[qi])]
        assert got_sc == [int(fine[c]) for c in exp]


def test_scan_respects_tombstones(rng):
    base, bank, codes = _mk(rng, n=300)
    queries = base[:3] + 0.01
    qc, _ = coding.encode(jnp.asarray(queries), bank)
    qbits = jnp.asarray(
        hamming_scan.unpack_bits_numpy(np.asarray(qc), bank.code_bits))
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    res0 = hamming_scan.scan(state, qbits, jnp.zeros(300, bool), 40,
                             approx=False)
    dead = [int(x) for x in np.asarray(res0.ids[0]) if x >= 0][:10]
    tomb = np.zeros(300, bool)
    tomb[dead] = True
    res1 = hamming_scan.scan(state, qbits, jnp.asarray(tomb), 40,
                             approx=False)
    got = {int(x) for x in np.asarray(res1.ids[0]) if x >= 0}
    assert not (got & set(dead))


def test_scan_approx_overlaps_exact(rng):
    base, bank, codes = _mk(rng, n=600)
    queries = rng.normal(size=(6, 24)).astype(np.float32) * 4
    qc, _ = coding.encode(jnp.asarray(queries), bank)
    qbits = jnp.asarray(
        hamming_scan.unpack_bits_numpy(np.asarray(qc), bank.code_bits))
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    limit = 100
    exact = hamming_scan.scan(state, qbits, jnp.zeros(600, bool), limit,
                              approx=False)
    approx = hamming_scan.scan(state, qbits, jnp.zeros(600, bool), limit,
                               approx=True)
    for qi in range(6):
        a = {int(x) for x in np.asarray(exact.ids[qi]) if x >= 0}
        b = {int(x) for x in np.asarray(approx.ids[qi]) if x >= 0}
        assert len(a & b) / limit >= 0.9


def test_scan_system_pipeline_and_restore(tmp_path, rng):
    """routing_mode=scan end-to-end: recall, decrypt budget, fast-restore
    equality."""
    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import (SystemConfig, PaperConfig, RuntimeConfig,
                                   EvalConfig)
    from fspann.io import groundtruth

    dim, n = 16, 1500
    centers = rng.normal(size=(16, dim)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, n)] + \
        rng.normal(size=(n, dim)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 20)] + \
        rng.normal(size=(20, dim)).astype(np.float32)
    cfg = SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=600, max_global_candidates=600,
                              block_size=32, routing_mode="scan",
                              rerank_limit=150),
        eval=EvalConfig(k_variants=(1, 10)),
    ).validate()
    root = str(tmp_path / "scan")
    sys_ = ForwardSecureANNSystem(cfg, root, dim, query_batch=8)
    try:
        sys_.index_stream(base, batch_size=400)
        sys_.finalize_for_search()
        gtm = groundtruth.precompute(base, queries, k=10)
        agg = sys_.run_queries(queries, gtm, base)
        assert agg.mean_cand_decrypted <= 150
        assert agg.recall_at_k[10] > 0.9, agg.paper_line()
        tok = sys_.create_token(queries[0], 10)
        before = [(r.id, round(r.distance, 5)) for r in sys_.search(tok)]
        sys_.flush_all()
    finally:
        sys_.shutdown()
    sys2 = ForwardSecureANNSystem(cfg, root, dim, query_batch=8)
    try:
        assert sys2.restore_index_from_disk()
        # scan servable: device state, or packed codes for the native kernel
        assert (sys2.index._scan_state is not None
                or sys2.index._scan_codes is not None)
        tok2 = sys2.create_token(queries[0], 10)
        after = [(r.id, round(r.distance, 5)) for r in sys2.search(tok2)]
        assert before == after
    finally:
        sys2.shutdown()


def test_scan_results_invariant_across_rotation(tmp_path, rng):
    """Scan-mode serving x forward security: rotation + selective
    re-encryption of the touched set leaves results bit-identical (the scan
    state is routing state — ciphertext migration cannot perturb it)."""
    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import (SystemConfig, PaperConfig, RuntimeConfig,
                                   EvalConfig)

    dim, n = 16, 1200
    base = rng.normal(size=(n, dim)).astype(np.float32) * 3
    queries = base[rng.integers(0, n, 12)] + \
        rng.normal(size=(12, dim)).astype(np.float32) * 0.05
    cfg = SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=400, max_global_candidates=400,
                              block_size=32, routing_mode="scan",
                              rerank_limit=120),
        eval=EvalConfig(k_variants=(1, 10)),
    ).validate()
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / "scanrot"), dim,
                                  query_batch=6)
    try:
        sys_.index_stream(base, batch_size=400)
        sys_.finalize_for_search()
        toks = [sys_.create_token(q, 10) for q in queries]
        before = [[(r.id, round(r.distance, 5)) for r in sys_.search(t)]
                  for t in toks]
        rep = sys_.run_selective_reencryption()
        assert rep["reencrypted"] > 0
        toks2 = [sys_.create_token(q, 10) for q in queries]
        after = [[(r.id, round(r.distance, 5)) for r in sys_.search(t)]
                 for t in toks2]
        assert before == after
    finally:
        sys_.shutdown()


def test_live_insert_after_finalize(tmp_path, rng):
    """insert_live: post-finalize points are searchable immediately (scan
    mode), survive fast restore, and the stale probe path refuses."""
    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import (SystemConfig, PaperConfig, RuntimeConfig,
                                   EvalConfig)

    dim, n = 16, 1200
    base = rng.normal(size=(n, dim)).astype(np.float32) * 3
    cfg = SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=400, max_global_candidates=400,
                              block_size=32, routing_mode="scan",
                              rerank_limit=100),
        eval=EvalConfig(k_variants=(1, 10)),
    ).validate()
    root = str(tmp_path / "live")
    sys_ = ForwardSecureANNSystem(cfg, root, dim, query_batch=4)
    try:
        sys_.index_stream(base, batch_size=400)
        sys_.finalize_for_search()
        new_vecs = rng.normal(size=(5, dim)).astype(np.float32) * 3 + 40.0
        new_ids = np.arange(n, n + 5)
        sys_.insert_live(new_ids, new_vecs)
        # each new point is its own nearest neighbor
        for i in range(5):
            tok = sys_.create_token(new_vecs[i], 3)
            res = sys_.search(tok)
            assert res[0].id == n + i
            # dot-form L2 at ||q|| ~ 160: f32 cancellation leaves ~0.05
            assert res[0].distance < 0.5
        # old points still found
        tok = sys_.create_token(base[7], 1)
        assert sys_.search(tok)[0].id == 7
        # duplicate id rejected
        with pytest.raises(ValueError):
            sys_.insert_live(np.array([n]), new_vecs[:1])
        sys_.flush_all()
        before = [(r.id, round(r.distance, 5))
                  for r in sys_.search(sys_.create_token(new_vecs[0], 10))]
    finally:
        sys_.shutdown()

    # restore picks up the appended rows via the refreshed checkpoint
    sys2 = ForwardSecureANNSystem(cfg, root, dim, query_batch=4)
    try:
        assert sys2.restore_index_from_disk()
        assert sys2.index.size == n + 5
        after = [(r.id, round(r.distance, 5))
                 for r in sys2.search(sys2.create_token(new_vecs[0], 10))]
        assert before == after
    finally:
        sys2.shutdown()

    # probe-mode restore of a stale checkpoint falls back to rebuild (and
    # the rebuilt index routes the appended points too)
    import dataclasses
    cfg_probe = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, routing_mode="probe"))
    sys3 = ForwardSecureANNSystem(cfg_probe, root, dim, query_batch=4)
    try:
        assert sys3.restore_index_from_disk()
        assert not sys3.index._table_stale
        tok = sys3.create_token(new_vecs[0], 3)
        assert sys3.search(tok)[0].id == n
    finally:
        sys3.shutdown()


def test_scan_chunked_matches_flat_exact(rng):
    """Chunked running-top-L scan (chunk smaller than the corpus, with a
    tail-overlap block) == flat scan, exact mode."""
    import jax.numpy as jnp
    base, bank, codes = _mk(rng, n=700)
    queries = rng.normal(size=(7, 24)).astype(np.float32) * 4
    qc, _ = coding.encode(jnp.asarray(queries), bank)
    qbits = jnp.asarray(
        hamming_scan.unpack_bits_numpy(np.asarray(qc), bank.code_bits))
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    tomb = np.zeros(700, bool)
    tomb[rng.integers(0, 700, 30)] = True
    tomb_d = jnp.asarray(tomb)
    flat = hamming_scan.scan(state, qbits, tomb_d, 60, approx=False)
    # 256-row chunks: 3 chunks, last one re-reads 68 overlap rows
    chunked = hamming_scan.scan_chunked(state, qbits, tomb_d, 60,
                                        chunk=256, approx=False)
    np.testing.assert_array_equal(np.asarray(flat.ids),
                                  np.asarray(chunked.ids))
    np.testing.assert_array_equal(np.asarray(flat.scores),
                                  np.asarray(chunked.scores))
    np.testing.assert_array_equal(np.asarray(flat.n_unique),
                                  np.asarray(chunked.n_unique))


def test_scan_system_delete_and_undelete(tmp_path, rng):
    """delete/undelete visibility flows through the scan's tombstone mask."""
    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import (SystemConfig, PaperConfig, RuntimeConfig,
                                   EvalConfig)

    dim, n = 16, 900
    base = rng.normal(size=(n, dim)).astype(np.float32) * 3
    cfg = SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=300, max_global_candidates=300,
                              block_size=32, routing_mode="scan",
                              rerank_limit=80),
        eval=EvalConfig(k_variants=(1, 10))).validate()
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / "del"), dim,
                                  query_batch=4)
    try:
        sys_.index_stream(base, batch_size=300)
        sys_.finalize_for_search()
        tok = sys_.create_token(base[42], 1)
        assert sys_.search(tok)[0].id == 42
        sys_.delete([42])
        tok2 = sys_.create_token(base[42], 1)
        assert sys_.search(tok2)[0].id != 42
        assert sys_.undelete([42]) == [42]
        tok3 = sys_.create_token(base[42], 1)
        assert sys_.search(tok3)[0].id == 42
    finally:
        sys_.shutdown()


# ---------------------------------------------------------------------------
# packed scan state (8x-less-HBM layout, per-chunk device unpack)
# ---------------------------------------------------------------------------


def test_packed_scan_matches_unpacked(rng):
    """PackedScanState through the chunked scan == unpacked flat scan,
    bit-exactly, including tombstones and the adaptive n_dec counts."""
    base, bank, codes = _mk(rng, n=700)
    queries = rng.normal(size=(7, 24)).astype(np.float32) * 4
    qc, _ = coding.encode(jnp.asarray(queries), bank)
    qbits = jnp.asarray(
        hamming_scan.unpack_bits_numpy(np.asarray(qc), bank.code_bits))
    tomb = np.zeros(700, bool)
    tomb[rng.integers(0, 700, 30)] = True
    tomb_d = jnp.asarray(tomb)
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    packed = hamming_scan.build_scan_state_packed(codes, bank.code_bits)
    np.testing.assert_array_equal(np.asarray(state.popc),
                                  np.asarray(packed.popc))
    flat = hamming_scan.scan(state, qbits, tomb_d, 60, approx=False,
                             anchor=10, margin=6)
    pk = hamming_scan.scan_chunked(packed, qbits, tomb_d, 60, chunk=256,
                                   approx=False, anchor=10, margin=6,
                                   code_bits=bank.code_bits)
    np.testing.assert_array_equal(np.asarray(flat.ids), np.asarray(pk.ids))
    np.testing.assert_array_equal(np.asarray(flat.scores),
                                  np.asarray(pk.scores))
    np.testing.assert_array_equal(np.asarray(flat.n_dec),
                                  np.asarray(pk.n_dec))


def test_packed_scan_small_corpus_fallback(rng):
    """n <= chunk: the packed state unpacks whole on-device and takes the
    flat path — still bit-exact."""
    base, bank, codes = _mk(rng, n=200)
    queries = rng.normal(size=(4, 24)).astype(np.float32) * 4
    qc, _ = coding.encode(jnp.asarray(queries), bank)
    qbits = jnp.asarray(
        hamming_scan.unpack_bits_numpy(np.asarray(qc), bank.code_bits))
    tomb = jnp.zeros(200, bool)
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    packed = hamming_scan.build_scan_state_packed(codes, bank.code_bits)
    a = hamming_scan.scan(state, qbits, tomb, 40, approx=False)
    b = hamming_scan.scan_chunked(packed, qbits, tomb, 40, chunk=1024,
                                  approx=False, code_bits=bank.code_bits)
    np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
    np.testing.assert_array_equal(np.asarray(a.scores),
                                  np.asarray(b.scores))


def test_packed_scan_requires_code_bits(rng):
    base, bank, codes = _mk(rng, n=64)
    packed = hamming_scan.build_scan_state_packed(codes, bank.code_bits)
    with pytest.raises(ValueError, match="code_bits"):
        hamming_scan.scan_chunked(packed, jnp.zeros((2, 40), jnp.int8),
                                  jnp.zeros(64, bool), 10)


def test_packed_system_end_to_end(tmp_path, rng):
    """scan_packed='on' at the system level: identical results to 'off',
    live insert appends packed words, checkpoint restore preserves the
    packed layout choice."""
    import dataclasses
    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import SystemConfig, PaperConfig, RuntimeConfig
    from fspann.ops import hamming_scan as hs

    n, d, q, k = 3000, 16, 6, 10
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    queries = base[rng.integers(0, n, q)] + \
        rng.normal(size=(q, d)).astype(np.float32) * 0.05

    def mk(packed, path):
        cfg = SystemConfig(
            paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
            runtime=RuntimeConfig(refinement_limit=400,
                                  max_global_candidates=400,
                                  block_size=32, routing_mode="scan",
                                  # this test targets the DEVICE packed
                                  # layout; keep the native CPU kernel out
                                  scan_native="off",
                                  scan_packed=packed)).validate()
        s = ForwardSecureANNSystem(cfg, str(tmp_path / path), d,
                                   query_batch=q)
        s.index_stream(base, batch_size=1500)
        s.finalize_for_search()
        return s

    def results(s, vec, kk):
        tok = s.create_token(vec, kk)
        return [(r.id, round(float(r.distance), 5)) for r in s.search(tok)]

    s_off = mk("off", "off")
    s_on = mk("on", "on")
    assert isinstance(s_on.index._scan_state, hs.PackedScanState)
    assert isinstance(s_off.index._scan_state, hs.ScanState)
    for qi in range(q):
        assert results(s_off, queries[qi], k) == results(s_on, queries[qi],
                                                         k)

    # live insert appends packed words and is immediately searchable
    new = rng.normal(size=(5, d)).astype(np.float32) * 4
    new_ids = np.arange(n, n + 5, dtype=np.int64)
    s_on.insert_live(new_ids, new)
    s_off.insert_live(new_ids, new)
    qn = new[2] + 0.01
    a = results(s_on, qn, 5)
    assert a == results(s_off, qn, 5)
    assert new_ids[2] in [i for i, _ in a]

    # restore keeps the configured layout and the results
    r_on = [results(s_on, queries[qi], k) for qi in range(q)]
    s_on.flush_all()
    s_on.shutdown()
    cfg2 = dataclasses.replace(
        s_off.cfg, runtime=dataclasses.replace(s_off.cfg.runtime,
                                               scan_packed="on"))
    back = ForwardSecureANNSystem(cfg2, str(tmp_path / "on"), d,
                                  query_batch=q)
    assert back.restore_index_from_disk() == n + 5
    assert isinstance(back.index._scan_state, hs.PackedScanState)
    assert [results(back, queries[qi], k) for qi in range(q)] == r_on
    back.shutdown()
    s_off.shutdown()
