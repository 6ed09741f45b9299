"""Adaptive per-query decrypt budget (scan mode).

The device scan returns n_dec[q] = |{i : score_i <= score_anchor + margin}|
clamped to [floor/anchor, L]; the host decrypts only that many ranked ids.
Covers: the device count against a numpy oracle, chunked/flat equality,
tombstone exclusion, and system-level behavior (saturated margin is
bit-identical to adaptive-off; a tight margin cuts decrypts without
spurious retries; probe mode is untouched)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from fspann.ops import coding, hamming_scan


def _mk(rng, n=500, d=24, m=10, lam=2, tables=2, divisions=2, seed=3):
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    bank = coding.build_bank_from_sample(base[:256], m, lam, tables,
                                         divisions, seed)
    codes, _ = coding.encode(jnp.asarray(base), bank)
    return base, bank, np.asarray(codes)


def _scan_setup(rng, n=400, nq=6):
    base, bank, codes = _mk(rng, n=n)
    queries = rng.normal(size=(nq, 24)).astype(np.float32) * 4
    qc, _ = coding.encode(jnp.asarray(queries), bank)
    qbits = hamming_scan.unpack_bits_numpy(np.asarray(qc), bank.code_bits)
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    return state, jnp.asarray(qbits)


def test_n_dec_matches_numpy_oracle(rng):
    state, qbits = _scan_setup(rng)
    limit, anchor, margin = 80, 10, 6
    res = hamming_scan.scan(state, qbits, jnp.zeros(400, bool), limit,
                            approx=False, anchor=anchor, margin=margin)
    scores = np.asarray(res.scores)
    n_dec = np.asarray(res.n_dec)
    for qi in range(scores.shape[0]):
        want = int((scores[qi] <= scores[qi, anchor - 1] + margin).sum())
        want = min(max(want, anchor), limit)
        assert n_dec[qi] == want, qi
    # budget never exceeds L, never undercuts the anchor
    assert (n_dec >= anchor).all() and (n_dec <= limit).all()


def test_n_dec_monotone_in_margin_and_floor(rng):
    state, qbits = _scan_setup(rng)
    tomb = jnp.zeros(400, bool)
    prev = None
    for margin in (2, 8, 32, 1000):
        nd = np.asarray(hamming_scan.scan(
            state, qbits, tomb, 80, approx=False, anchor=10,
            margin=margin).n_dec)
        if prev is not None:
            assert (nd >= prev).all()
        prev = nd
    # a saturated margin counts every live row
    assert (prev == 80).all()
    floored = np.asarray(hamming_scan.scan(
        state, qbits, tomb, 80, approx=False, anchor=10, margin=1,
        floor=50).n_dec)
    assert (floored >= 50).all()


def test_n_dec_absent_when_disabled(rng):
    state, qbits = _scan_setup(rng)
    res = hamming_scan.scan(state, qbits, jnp.zeros(400, bool), 80)
    assert res.n_dec is None


def test_n_dec_chunked_equals_flat(rng):
    state, qbits = _scan_setup(rng)
    tomb = np.zeros(400, bool)
    tomb[::7] = True
    flat = hamming_scan.scan(state, qbits, jnp.asarray(tomb), 64,
                             approx=False, anchor=10, margin=8)
    chunked = hamming_scan.scan_chunked(state, qbits, jnp.asarray(tomb), 64,
                                        chunk=96, approx=False, anchor=10,
                                        margin=8)
    np.testing.assert_array_equal(np.asarray(flat.n_dec),
                                  np.asarray(chunked.n_dec))
    np.testing.assert_array_equal(np.asarray(flat.ids),
                                  np.asarray(chunked.ids))


def test_n_dec_counts_only_live_rows(rng):
    state, qbits = _scan_setup(rng)
    # tombstone everything but 30 rows: with fewer live rows than the
    # anchor, the clamped threshold must count all live rows, not wrap
    tomb = np.ones(400, bool)
    tomb[:30] = False
    res = hamming_scan.scan(state, qbits, jnp.asarray(tomb), 80,
                            approx=False, anchor=50, margin=4)
    n_dec = np.asarray(res.n_dec)
    live = (np.asarray(res.ids) >= 0).sum(axis=1)
    assert (live == 30).all()
    # the budget may exceed the live count (clamp floor = anchor) but the
    # extra slots are pads (-1) the host AES loop skips
    assert (n_dec >= 30).all()


# ---------------------------------------------------------------------------
# system level
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_system(tmp_path_factory):
    import jax

    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import (SystemConfig, PaperConfig, RuntimeConfig,
                                   EvalConfig)
    from fspann.io import synthetic, groundtruth

    del jax  # platform forced by conftest
    rng = np.random.default_rng(5)
    n, d = 20_000, 32
    base, queries = synthetic.lsh_hard_corpus(n, d, 32, seed=5)
    del rng
    cfg = SystemConfig(
        paper=PaperConfig(m=12, lam=2, divisions=2, tables=4, seed=13),
        runtime=RuntimeConfig(block_size=64, encode_backend="cpu",
                              refinement_limit=8_000,
                              max_global_candidates=8_000,
                              rerank_limit=1_000, routing_mode="scan"),
        eval=EvalConfig(k_variants=(1, 10, 100))).validate()
    s = ForwardSecureANNSystem(
        cfg, str(tmp_path_factory.mktemp("adapt") / "db"), d, query_batch=16)
    s.index_stream(base, batch_size=10_000)
    s.finalize_for_search()
    gtm = groundtruth.precompute(base, queries, k=100)
    return s, cfg, base, queries, gtm


def _with_margin(s, cfg, margin, floor=0):
    c2 = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, adaptive_decrypt_margin=margin,
        adaptive_decrypt_floor=floor)).validate()
    for obj in (s, s.index, s.query_service):
        obj.cfg = c2
    return c2


def test_saturated_margin_identical_to_off(small_system):
    s, cfg, base, queries, gtm = small_system
    _with_margin(s, cfg, 0)
    s.profiler.clear_rows()
    off = s.run_queries(queries, gtm, base)
    _with_margin(s, cfg, 10_000)   # n_dec == L for every query
    s.profiler.clear_rows()
    on = s.run_queries(queries, gtm, base)
    assert on.recall_at_k == pytest.approx(off.recall_at_k)
    assert on.mean_cand_decrypted == off.mean_cand_decrypted


def test_tight_margin_cuts_decrypts_no_spurious_retry(small_system):
    s, cfg, base, queries, gtm = small_system
    _with_margin(s, cfg, 0)
    s.profiler.clear_rows()
    off = s.run_queries(queries, gtm, base)
    # moderate margin (~1 std of the 192-bit code): big decrypt cut at
    # near-equal recall
    _with_margin(s, cfg, 15)
    s.profiler.clear_rows()
    on = s.run_queries(queries, gtm, base)
    assert on.mean_cand_decrypted < off.mean_cand_decrypted
    assert on.recall_at_k[10] >= off.recall_at_k[10] - 0.05
    assert not any(r.retried for r in s.profiler.rows)
    # extreme margin (score-ties only): budget collapses toward the anchor
    # floor, results stay full-length, still no spurious retry
    _with_margin(s, cfg, 1)
    s.profiler.clear_rows()
    ext = s.run_queries(queries, gtm, base)
    assert ext.mean_cand_decrypted < on.mean_cand_decrypted
    assert not any(r.retried for r in s.profiler.rows)
    assert min(r.returned for r in s.profiler.rows) >= 10
    _with_margin(s, cfg, 0)


def test_probe_mode_unaffected_by_margin(small_system):
    s, cfg, base, queries, gtm = small_system
    rt = dataclasses.replace(cfg.runtime, routing_mode="probe",
                             probe_override=8)
    base_cfg = dataclasses.replace(cfg, runtime=rt).validate()
    for obj in (s, s.index, s.query_service):
        obj.cfg = base_cfg
    s.profiler.clear_rows()
    off = s.run_queries(queries, gtm, base)
    rt2 = dataclasses.replace(rt, adaptive_decrypt_margin=50)
    for obj in (s, s.index, s.query_service):
        obj.cfg = dataclasses.replace(cfg, runtime=rt2).validate()
    s.profiler.clear_rows()
    on = s.run_queries(queries, gtm, base)
    assert on.recall_at_k == pytest.approx(off.recall_at_k)
    assert on.mean_cand_decrypted == off.mean_cand_decrypted
    for obj in (s, s.index, s.query_service):
        obj.cfg = cfg


def test_run_queries_aggregates_only_own_rows(small_system):
    """Back-to-back run_queries on ONE system with different operating
    points must each report their OWN run — not a running average (the
    round-3 calibration-contamination bug: sweeps without clear_rows
    reported means over every previous point)."""
    s, cfg, base, queries, gtm = small_system
    _with_margin(s, cfg, 0)
    full = s.run_queries(queries, gtm, base)
    _with_margin(s, cfg, 1)
    tight = s.run_queries(queries, gtm, base)      # no clear_rows between
    s.profiler.clear_rows()
    tight_clean = s.run_queries(queries, gtm, base)
    assert tight.mean_cand_decrypted == tight_clean.mean_cand_decrypted
    assert tight.mean_cand_decrypted < full.mean_cand_decrypted
    assert tight.num_queries == len(queries)
    _with_margin(s, cfg, 0)


def test_config_validation():
    from fspann.config import SystemConfig, RuntimeConfig

    with pytest.raises(ValueError):
        SystemConfig(runtime=RuntimeConfig(
            adaptive_decrypt_margin=-1)).validate()
    c = SystemConfig(runtime=RuntimeConfig(
        adaptive_decrypt_margin=50, adaptive_decrypt_anchor=1)).validate()
    # anchor is clamped up to max_k so every K variant stays answerable
    assert c.runtime.adaptive_decrypt_anchor >= c.eval.max_k
