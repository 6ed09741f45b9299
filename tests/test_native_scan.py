"""Native packed Hamming scan (ops/native_scan + ops/native/hamming_topl.c).

The kernel must be bit-interchangeable with the device scan: same Hamming
scores, same (score, id)-ascending order, same RouteResult contract
(-1/INT32_MAX pads, adaptive decrypt budget), so CPU serving and GPU
serving return identical results for identical requests.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from fspann.ops import coding, hamming_scan, native_scan

pytestmark = pytest.mark.skipif(not native_scan.available(),
                                reason="native scan library not buildable")

INF = np.iinfo(np.int32).max


def _mk(rng, n=500, d=24, m=10, lam=2, tables=2, divisions=2, seed=3):
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    bank = coding.build_bank_from_sample(base[:256], m, lam, tables,
                                         divisions, seed)
    codes, _ = coding.encode(jnp.asarray(base), bank)
    return base, bank, np.asarray(codes)


def _queries(rng, bank, d=24, q=9):
    qs = rng.normal(size=(q, d)).astype(np.float32) * 4
    qc, _ = coding.encode(jnp.asarray(qs), bank)
    return np.asarray(qc)


def test_matches_device_scan_bit_exact(rng):
    base, bank, codes = _mk(rng, n=400)
    qcodes = _queries(rng, bank)
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    qbits = jnp.asarray(
        hamming_scan.unpack_bits_numpy(qcodes, bank.code_bits))
    dev = hamming_scan.scan(state, qbits, jnp.zeros(400, bool), 50,
                            approx=False)
    nat = native_scan.scan_topl(codes, qcodes, None, 50)
    np.testing.assert_array_equal(np.asarray(dev.ids), nat.ids)
    np.testing.assert_array_equal(np.asarray(dev.scores), nat.scores)
    np.testing.assert_array_equal(np.asarray(dev.n_unique), nat.n_unique)


def test_matches_chunked_scan_with_dead_mask(rng):
    base, bank, codes = _mk(rng, n=300)
    qcodes = _queries(rng, bank, q=5)
    dead = rng.random(300) < 0.3
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    qbits = jnp.asarray(
        hamming_scan.unpack_bits_numpy(qcodes, bank.code_bits))
    dev = hamming_scan.scan_chunked(state, qbits, jnp.asarray(dead), 40,
                                    chunk=64)
    nat = native_scan.scan_topl(codes, qcodes, dead, 40)
    np.testing.assert_array_equal(np.asarray(dev.ids), nat.ids)
    np.testing.assert_array_equal(np.asarray(dev.scores), nat.scores)


def test_pads_when_l_exceeds_live(rng):
    base, bank, codes = _mk(rng, n=60)
    qcodes = _queries(rng, bank, q=3)
    dead = np.zeros(60, bool)
    dead[10:] = True          # 10 live rows, ask for 25
    ids, scores, n_live = native_scan.hamming_topl(codes, qcodes, dead, 25)
    assert n_live == 10
    assert (ids[:, 10:] == -1).all() and (scores[:, 10:] == INF).all()
    assert (ids[:, :10] >= 0).all() and (ids[:, :10] < 10).all()
    # still sorted (score, id) ascending
    for qi in range(3):
        key = scores[qi, :10].astype(np.int64) * 1000 + ids[qi, :10]
        assert (np.diff(key) > 0).all()


def test_adaptive_budget_matches_device(rng):
    base, bank, codes = _mk(rng, n=500)
    qcodes = _queries(rng, bank, q=7)
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    qbits = jnp.asarray(
        hamming_scan.unpack_bits_numpy(qcodes, bank.code_bits))
    dev = hamming_scan.scan(state, qbits, jnp.zeros(500, bool), 80,
                            approx=False, anchor=10, margin=3, floor=5)
    nat = native_scan.scan_topl(codes, qcodes, None, 80,
                                anchor=10, margin=3, floor=5)
    np.testing.assert_array_equal(np.asarray(dev.n_dec), nat.n_dec)


def test_wide_codes_and_query_tails(rng):
    """w32 = 24 words (SIMD body + masked tail) and q = 11 (one 8-block +
    3 tail queries) against the device scan — the small default geometry
    (w32 = 4) never leaves the masked-tail path."""
    base, bank, codes = _mk(rng, n=350, d=48, m=40, lam=2, tables=4,
                            divisions=2)
    assert codes.shape[1] * codes.shape[2] == 24, codes.shape
    qs = rng.normal(size=(11, 48)).astype(np.float32) * 4
    qcodes = np.asarray(coding.encode(jnp.asarray(qs), bank)[0])
    state = hamming_scan.build_scan_state(codes, bank.code_bits)
    qbits = jnp.asarray(
        hamming_scan.unpack_bits_numpy(qcodes, bank.code_bits))
    dev = hamming_scan.scan(state, qbits, jnp.zeros(350, bool), 64,
                            approx=False)
    nat = native_scan.scan_topl(codes, qcodes, None, 64)
    np.testing.assert_array_equal(np.asarray(dev.ids), nat.ids)
    np.testing.assert_array_equal(np.asarray(dev.scores), nat.scores)


def test_threads_do_not_change_results(rng):
    base, bank, codes = _mk(rng, n=700)
    qcodes = _queries(rng, bank, q=4)
    one = native_scan.hamming_topl(codes, qcodes, None, 64, threads=1)
    four = native_scan.hamming_topl(codes, qcodes, None, 64, threads=4)
    np.testing.assert_array_equal(one[0], four[0])
    np.testing.assert_array_equal(one[1], four[1])
    assert one[2] == four[2]


def test_index_service_native_equals_xla(rng, tmp_path):
    """route_batch(scan_native='on') ≡ route_batch(scan_native='off')
    end to end through the index service, including tombstones."""
    from fspann.config import SystemConfig
    from fspann.index.service import PartitionedIndex

    def build(scan_native):
        cfg = SystemConfig()
        cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime,
            routing_mode="scan", refinement_limit=60,
            scan_native=scan_native, adaptive_decrypt_margin=4,
            adaptive_decrypt_anchor=10, adaptive_decrypt_floor=5)).validate()
        idx = PartitionedIndex(cfg, dim=24)
        idx.stage(ids, base)
        idx.finalize()
        idx.mark_deleted([3, 17, 44])
        return idx

    base = rng.normal(size=(300, 24)).astype(np.float32) * 4
    ids = np.arange(300)
    queries = rng.normal(size=(6, 24)).astype(np.float32) * 4
    a = build("on")
    b = build("off")
    qc_a = a.encode_queries(queries)
    qc_b = b.encode_queries(queries)
    ra = a.route_batch(*qc_a)
    rb = b.route_batch(*qc_b)
    np.testing.assert_array_equal(np.asarray(ra.ids), np.asarray(rb.ids))
    np.testing.assert_array_equal(np.asarray(ra.scores),
                                  np.asarray(rb.scores))
    np.testing.assert_array_equal(np.asarray(ra.n_dec), np.asarray(rb.n_dec))


def test_restore_preserves_native_results(rng, tmp_path):
    """save_table → fresh index → load_table: the native backend returns
    the same ranking from restored packed codes (the routing state is a
    deterministic function of seed + config + persisted codes)."""
    from fspann.config import SystemConfig
    from fspann.index.service import PartitionedIndex

    cfg = SystemConfig()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, routing_mode="scan", refinement_limit=50,
        scan_native="on")).validate()
    base = rng.normal(size=(250, 24)).astype(np.float32) * 4
    queries = rng.normal(size=(5, 24)).astype(np.float32) * 4

    bank_p = str(tmp_path / "bank.npz")
    table_p = str(tmp_path / "table.npz")
    a = PartitionedIndex(cfg, dim=24, bank_path=bank_p)
    a.stage(np.arange(250), base)
    a.finalize()
    ra = a.route_batch(*a.encode_queries(queries))
    a.save_table(table_p)

    b = PartitionedIndex(cfg, dim=24, bank_path=bank_p)
    assert b.load_table(table_p, expect_rows=250)
    rb = b.route_batch(*b.encode_queries(queries))
    np.testing.assert_array_equal(np.asarray(ra.ids), np.asarray(rb.ids))
    np.testing.assert_array_equal(np.asarray(ra.scores),
                                  np.asarray(rb.scores))


def test_scan_native_config_validation():
    from fspann.config import SystemConfig
    cfg = SystemConfig()
    with pytest.raises(ValueError, match="scan_native"):
        dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, scan_native="maybe")).validate()
