"""Distributed encrypted serving: device-sharded routing + shard-aligned
host ciphertext stores (the multi-device stretch configuration of
BASELINE.json, exercised on the virtual 8-device CPU mesh)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fspann.crypto.keys import KeyManager
from fspann.ops import coding, refine, routing
from fspann.parallel.sharded import ShardedIndex, make_mesh
from fspann.store.sharded_store import ShardedPointStore


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device mesh")
def test_sharded_encrypted_pipeline(tmp_path, rng):
    """Route on the sharded device index, decrypt candidates from the
    shard-aligned encrypted store, refine on host — full encrypted path at
    mesh scale."""
    n, d, q, k = 2048, 16, 6, 10
    centers = rng.normal(size=(16, d)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    mesh = make_mesh()
    ndev = mesh.devices.size
    bank = coding.build_bank_from_sample(base[:1000], m=8, lam=2, tables=3,
                                         divisions=2, seed=13)

    # device: corpus-sharded routing index
    idx = ShardedIndex(mesh, bank, block_size=32)
    idx.build(base)

    # host: ciphertext shards aligned with device shards (range placement)
    km = KeyManager(str(tmp_path / "ks"))
    store = ShardedPointStore(str(tmp_path / "db"), km, d, num_shards=ndev,
                              placement="range")
    store.set_range_size(idx.shard_rows)
    store.insert_batch(np.arange(n), base)

    # stage A on the mesh: per-shard routing (reuse the plaintext query step
    # for candidate generation only — take a large K as the candidate set)
    cand_k = 64
    ids, _ = idx.query(queries, probes=3, refinement_limit=256, k=cand_k)

    # stage B on host: decrypt candidates from the sharded encrypted store
    flat = ids.reshape(-1)
    vecs, ok = store.load_decrypt_batch(flat)
    cand_vecs = vecs.reshape(q, cand_k, d)
    valid = ok.reshape(q, cand_k)
    assert valid[ids >= 0].all()

    # stage C: exact refine
    res = refine.refine(jnp.asarray(queries), jnp.asarray(cand_vecs),
                        jnp.asarray(ids, jnp.int32), jnp.asarray(valid), k)
    got = np.asarray(res.ids)

    gt_ids, _ = refine.bruteforce_topk(base, queries, k)
    hits = sum(len(set(got[i].tolist()) & set(gt_ids[i].tolist()))
               for i in range(q))
    assert hits / (q * k) > 0.9

    # forward security holds at mesh scale: rotate + migrate a shard's worth
    km.rotate()
    rep = store.reencrypt_ids(np.arange(0, n, 2))
    assert rep.reencrypted == n // 2
    vecs2, ok2 = store.load_decrypt_batch(flat)
    assert (ok2 == ok).all()
    np.testing.assert_allclose(vecs2, vecs, rtol=1e-6)
    store.close()


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device mesh")
def test_distributed_encrypted_system_facade(tmp_path, rng):
    """DistributedEncryptedSystem: build (no plaintext kept in HBM) ->
    encrypted search -> rotation leaves results bit-identical."""
    from fspann.config import SystemConfig, PaperConfig, RuntimeConfig
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, q, k = 2048, 16, 6, 10
    centers = rng.normal(size=(16, d)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    cfg = SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=512,
                              max_global_candidates=512,
                              default_probes=4, block_size=32)).validate()
    sys_ = DistributedEncryptedSystem(cfg, str(tmp_path / "db"), d)
    try:
        sys_.build(base)
        assert sys_.index.base is None        # no plaintext in HBM
        ids, dists = sys_.search_batch(queries, k)
        assert ids.shape == (q, k)
        gt_ids, _ = refine.bruteforce_topk(base, queries, k)
        hits = sum(len(set(ids[i][ids[i] >= 0].tolist())
                       & set(gt_ids[i].tolist())) for i in range(q))
        assert hits / (q * k) > 0.9

        rep = sys_.rotate_and_migrate()
        assert rep.reencrypted == n
        ids2, dists2 = sys_.search_batch(queries, k)
        np.testing.assert_array_equal(ids, ids2)
        np.testing.assert_allclose(dists, dists2, rtol=1e-6)

        # probe_shards subset: results restricted to the first shards' rows
        ids3, _ = sys_.search_batch(queries, k, probe_shards=2)
        live = ids3[ids3 >= 0]
        assert (live < 2 * sys_.index.shard_rows).all()
    finally:
        sys_.close()


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device mesh")
def test_sharded_rerank_matches_global_fine_hamming(rng):
    """Mesh route with rerank: per-shard fine-Hamming truncation + merge
    equals the global top-L by full-code Hamming over the routed union."""
    n, d = 1024, 16
    base = rng.normal(size=(n, d)).astype(np.float32) * 3
    queries = base[rng.integers(0, n, 5)] + \
        rng.normal(size=(5, d)).astype(np.float32) * 0.1

    mesh = make_mesh()
    bank = coding.build_bank_from_sample(base[:1000], m=8, lam=2, tables=3,
                                         divisions=2, seed=13)
    idx = ShardedIndex(mesh, bank, block_size=32)
    idx.build(base, keep_base=False, keep_codes=True)

    # width ≥ per-shard G*probes*block so no local or global truncation:
    # `wide` is then exactly the union of per-shard routed sets, which is
    # the pool the per-shard rerank truncation draws from
    wide_r = 1024
    wide, _ = idx.route(queries, probes=3, refinement_limit=wide_r)
    limit = 60
    got_ids, got_sc = idx.route(queries, probes=3, refinement_limit=wide_r,
                                rerank_limit=limit)

    codes_all, _ = coding.encode(jnp.asarray(base), bank)
    codes_np = np.asarray(codes_all)        # [N, G, W]
    qc, _ = coding.encode(jnp.asarray(queries), bank)
    qc_np = np.asarray(qc)
    for qi in range(len(queries)):
        cand = [int(x) for x in wide[qi] if x >= 0]
        fine = {c: int(np.unpackbits(np.bitwise_xor(
            codes_np[c], qc_np[qi]).view(np.uint8)).sum()) for c in cand}
        exp = sorted(cand, key=lambda c: (fine[c], c))[:limit]
        got = [int(x) for x in got_ids[qi] if x >= 0]
        assert got == exp, f"q={qi}"
        live_sc = [int(s) for x, s in zip(got_ids[qi], got_sc[qi]) if x >= 0]
        assert live_sc == [fine[c] for c in exp]


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device mesh")
def test_distributed_system_rerank_recall(tmp_path, rng):
    """DistributedEncryptedSystem with rerank: the truncated decrypt set
    still recovers the true neighbors."""
    import dataclasses
    from fspann.config import SystemConfig, PaperConfig, RuntimeConfig
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, q, k = 2048, 16, 6, 10
    centers = rng.normal(size=(16, d)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    cfg = SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=600, max_global_candidates=600,
                              block_size=32, rerank_limit=200)).validate()
    sys_ = DistributedEncryptedSystem(cfg, str(tmp_path / "dist_rr"), d)
    try:
        sys_.build(base)
        ids, dists = sys_.search_batch(queries, k)
        assert ids.shape == (q, k)
        # brute-force ground truth
        d2 = ((base[None] - queries[:, None]) ** 2).sum(-1)
        gt = np.argsort(d2, axis=1)[:, :k]
        hits = sum(len(set(ids[i]) & set(gt[i])) for i in range(q))
        assert hits / (q * k) > 0.9
    finally:
        sys_.close()


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device mesh")
def test_mesh_scan_matches_single_device_oracle(rng):
    """Sharded bit-matmul scan (exact variant) == numpy global fine-Hamming
    ranking — per-shard top-L + merge is exact."""
    from fspann.ops import hamming_scan

    n, d = 1024, 16
    base = rng.normal(size=(n, d)).astype(np.float32) * 3
    queries = base[rng.integers(0, n, 5)] + \
        rng.normal(size=(5, d)).astype(np.float32) * 0.1
    mesh = make_mesh()
    bank = coding.build_bank_from_sample(base[:1000], m=8, lam=2, tables=3,
                                         divisions=2, seed=13)
    idx = ShardedIndex(mesh, bank, block_size=32)
    idx.build(base, keep_base=False, keep_bits=True)
    limit = 60
    got_ids, got_sc = idx.scan_route(queries, limit=limit, approx=False)

    codes_all, _ = coding.encode(jnp.asarray(base), bank)
    bits = hamming_scan.unpack_bits_numpy(np.asarray(codes_all),
                                          bank.code_bits)
    qc, _ = coding.encode(jnp.asarray(queries), bank)
    qbits = hamming_scan.unpack_bits_numpy(np.asarray(qc), bank.code_bits)
    for qi in range(len(queries)):
        fine = np.bitwise_xor(bits, qbits[qi]).sum(axis=1)
        exp = sorted(range(n), key=lambda c: (int(fine[c]), c))[:limit]
        got = [int(x) for x in got_ids[qi] if x >= 0]
        assert got == exp, f"q={qi}"
        live_sc = [int(s) for x, s in zip(got_ids[qi], got_sc[qi]) if x >= 0]
        assert live_sc == [int(fine[c]) for c in exp]


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device mesh")
def test_distributed_system_scan_recall(tmp_path, rng):
    """DistributedEncryptedSystem in scan mode: encrypted mesh serving with
    the per-shard bit-matmul stage A."""
    import dataclasses
    from fspann.config import SystemConfig, PaperConfig, RuntimeConfig
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, q, k = 2048, 16, 6, 10
    centers = rng.normal(size=(16, d)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)

    cfg = SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=600, max_global_candidates=600,
                              block_size=32, rerank_limit=200,
                              routing_mode="scan")).validate()
    sys_ = DistributedEncryptedSystem(cfg, str(tmp_path / "dist_scan"), d)
    try:
        sys_.build(base)
        ids, dists = sys_.search_batch(queries, k)
        d2 = ((base[None] - queries[:, None]) ** 2).sum(-1)
        gt = np.argsort(d2, axis=1)[:, :k]
        hits = sum(len(set(ids[i]) & set(gt[i])) for i in range(q))
        assert hits / (q * k) > 0.9
    finally:
        sys_.close()


def test_sharded_store_fused_staging_matches_plain(tmp_path, rng):
    """out=/norms_out= scattered decrypt must reproduce the allocate-fresh
    path exactly, including fused norms (VERDICT r2 weak 4)."""
    n, d = 512, 12
    km = KeyManager(str(tmp_path / "ks.blob"))
    store = ShardedPointStore(str(tmp_path / "st"), km, d, num_shards=4)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    store.insert_batch(np.arange(n), vecs)
    try:
        ids = np.concatenate([rng.integers(0, n, 300),
                              np.full(20, -1, np.int64)])
        v0, ok0 = store.load_decrypt_batch(ids)
        out = np.zeros((len(ids), d), np.float32)
        norms = np.zeros(len(ids), np.float32)
        v1, ok1 = store.load_decrypt_batch(ids, out=out, norms_out=norms)
        assert v1 is out
        np.testing.assert_array_equal(ok0, ok1)
        np.testing.assert_array_equal(v0[ok0], out[ok1])
        expect = np.einsum("ij,ij->i", out[ok1], out[ok1])
        np.testing.assert_allclose(norms[ok1], expect, rtol=1e-5)
    finally:
        store.close()


def test_sharded_store_threaded_decrypt(tmp_path, rng, monkeypatch):
    """FSPANN_SHARD_THREADS>1 (oversubscribed on this 1-core host) must be
    a pure parallelization — bit-identical outputs, disjoint-row writes."""
    monkeypatch.setenv("FSPANN_SHARD_THREADS", "4")
    n, d = 1024, 8
    km = KeyManager(str(tmp_path / "ks.blob"))
    store = ShardedPointStore(str(tmp_path / "st"), km, d, num_shards=4)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    store.insert_batch(np.arange(n), vecs)
    try:
        ids = rng.permutation(n)[:800]
        out = np.zeros((len(ids), d), np.float32)
        norms = np.zeros(len(ids), np.float32)
        v, ok = store.load_decrypt_batch(ids, out=out, norms_out=norms)
        assert ok.all()
        np.testing.assert_allclose(v, vecs[ids], rtol=1e-6)
        np.testing.assert_allclose(
            norms, np.einsum("ij,ij->i", vecs[ids], vecs[ids]), rtol=1e-5)
    finally:
        store.close()


def test_build_stream_matches_oneshot(rng):
    """Streaming build must reproduce the one-shot build bit-exactly:
    chunks are encoded on their own shard device, so codes/keys/tables are
    identical (VERDICT r2 missing 3)."""
    n, d = 1600, 16
    base = rng.normal(size=(n, d)).astype(np.float32) * 3
    bank = coding.build_bank_from_sample(base[:512], 8, 2, 2, 2, 13)
    mesh = make_mesh()

    one = ShardedIndex(mesh, bank, block_size=16)
    one.build(base, keep_base=False, keep_bits=True)
    st = ShardedIndex(mesh, bank, block_size=16)
    # ragged chunk sizes crossing shard boundaries on purpose
    sizes = [300, 77, 423, 400, 256, 144]
    off = np.cumsum([0] + sizes)
    assert off[-1] == n
    total = st.build_stream((base[a:b] for a, b in zip(off, off[1:])), n,
                            keep_bits=True)
    assert total == n
    assert st.shard_rows == one.shard_rows

    queries = rng.normal(size=(5, d)).astype(np.float32) * 3
    ids_a, sc_a = one.scan_route(queries, limit=64, approx=False)
    ids_b, sc_b = st.scan_route(queries, limit=64, approx=False)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(sc_a, sc_b)
    r_a = one.route(queries, probes=3, refinement_limit=128)
    r_b = st.route(queries, probes=3, refinement_limit=128)
    np.testing.assert_array_equal(r_a[0], r_b[0])


def test_distributed_index_stream_encrypted(tmp_path, rng):
    """Facade streaming path: encrypt+persist per chunk from a TRUE
    generator (no len), then serve with the mesh scan — recall vs brute
    force, ciphertexts shard-aligned."""
    from fspann.config import (SystemConfig, PaperConfig, RuntimeConfig)
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, q, k = 2048, 16, 6, 10
    centers = rng.normal(size=(16, d)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)
    cfg = SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=512,
                              max_global_candidates=512, block_size=32,
                              routing_mode="scan"),
    ).validate()
    sys_ = DistributedEncryptedSystem(cfg, str(tmp_path / "dstream"), d)
    try:
        def gen():
            for i in range(0, n, 300):
                yield base[i:i + 300]

        assert sys_.index_stream(gen(), n_total=n) == n
        ids, dist = sys_.search_batch(queries, k)
        assert ids.shape == (q, k)
        d2 = ((base[None] - queries[:, None]) ** 2).sum(-1)
        true_ids = np.argsort(d2, axis=1)[:, :k]
        hits = sum(len(set(ids[i].tolist()) & set(true_ids[i].tolist()))
                   for i in range(q))
        assert hits / (q * k) >= 0.9
        # range placement really put each id's ciphertext on its shard
        rows = sys_.index.shard_rows
        for s, shard_store in enumerate(sys_.store.shards):
            n_live = len(shard_store.meta)
            expect = max(0, min(n - s * rows, rows))
            assert n_live == expect
    finally:
        sys_.close()


def _scan_cfg(d):
    from fspann.config import SystemConfig, PaperConfig, RuntimeConfig
    return SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=512,
                              max_global_candidates=512, block_size=32,
                              routing_mode="scan"),
    ).validate()


def test_mesh_live_insert_matches_full_build(rng):
    """append_scan_rows == building over the full corpus at the same
    capacity: appended rows are encoded on the same shard device, so the
    scan results are bit-identical (VERDICT r2 missing 4)."""
    n0, n1, d, cap = 1500, 300, 16, 2048
    base = rng.normal(size=(n0 + n1, d)).astype(np.float32) * 3
    bank = coding.build_bank_from_sample(base[:512], 8, 2, 2, 2, 13)
    mesh = make_mesh()

    live = ShardedIndex(mesh, bank, block_size=16)
    live.build(base[:n0], keep_base=False, keep_bits=True, capacity=cap)
    ids = live.append_scan_rows(base[n0:])
    np.testing.assert_array_equal(ids, np.arange(n0, n0 + n1))
    assert live.n == n0 + n1

    full = ShardedIndex(mesh, bank, block_size=16)
    full.build(base, keep_base=False, keep_bits=True, capacity=cap)

    queries = rng.normal(size=(5, d)).astype(np.float32) * 3
    a_ids, a_sc = live.scan_route(queries, limit=64, approx=False)
    b_ids, b_sc = full.scan_route(queries, limit=64, approx=False)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_sc, b_sc)

    with pytest.raises(RuntimeError, match="capacity"):
        live.append_scan_rows(
            rng.normal(size=(cap, d)).astype(np.float32))


def test_distributed_insert_live_searchable_and_rotatable(tmp_path, rng):
    """Facade: insert_live rows are immediately searchable on the mesh,
    land on the correct shard arenas, and key rotation stays orthogonal
    (recall unchanged across rotate+migrate)."""
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, k = 1600, 16, 5
    centers = rng.normal(size=(12, d)).astype(np.float32) * 6
    base = centers[rng.integers(0, 12, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    sys_ = DistributedEncryptedSystem(_scan_cfg(d), str(tmp_path / "live"),
                                      d)
    try:
        sys_.build(base, capacity=2400)
        # a brand-new cluster far from everything, inserted live
        new = (np.full((40, d), 30.0)
               + rng.normal(size=(40, d))).astype(np.float32)
        ids = sys_.insert_live(new)
        assert ids[0] == n and sys_.n == n + 40
        q = np.full((1, d), 30.0, np.float32)
        got, dist = sys_.search_batch(q, k)
        assert set(got[0].tolist()) <= set(ids.tolist()), \
            "live-inserted rows not returned for their own cluster"
        # rotation + migration never touches routing state
        rep = sys_.rotate_and_migrate(np.arange(sys_.n))
        assert rep.reencrypted > 0
        got2, _ = sys_.search_batch(q, k)
        np.testing.assert_array_equal(got, got2)
    finally:
        sys_.close()


def test_mesh_checkpoint_restore_roundtrip(tmp_path, rng):
    """save_state/restore_state must reproduce scan + probe routing
    exactly — the mesh analogue of the single-chip fast restore."""
    n, d = 1600, 16
    base = rng.normal(size=(n, d)).astype(np.float32) * 3
    bank = coding.build_bank_from_sample(base[:512], 8, 2, 2, 2, 13)
    mesh = make_mesh()
    one = ShardedIndex(mesh, bank, block_size=16)
    one.build(base, keep_base=False, keep_bits=True, keep_codes=True)
    path = str(tmp_path / "mesh_state.npz")
    one.save_state(path)

    back = ShardedIndex.restore_state(path, mesh, keep_codes=True,
                                      keep_bits=True)
    assert back.n == n and back.shard_rows == one.shard_rows
    queries = rng.normal(size=(5, d)).astype(np.float32) * 3
    a_ids, a_sc = one.scan_route(queries, limit=64, approx=False)
    b_ids, b_sc = back.scan_route(queries, limit=64, approx=False)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_sc, b_sc)
    r_a = one.route(queries, probes=3, refinement_limit=128)
    r_b = back.route(queries, probes=3, refinement_limit=128)
    np.testing.assert_array_equal(r_a[0], r_b[0])


def test_mesh_checkpoint_from_bits_only(tmp_path, rng):
    """A scan-only build (no kept codes) must still checkpoint: codes are
    re-packed from the bit matrix losslessly."""
    n, d = 800, 16
    base = rng.normal(size=(n, d)).astype(np.float32) * 3
    bank = coding.build_bank_from_sample(base[:512], 8, 2, 2, 2, 13)
    mesh = make_mesh()
    one = ShardedIndex(mesh, bank, block_size=16)
    one.build(base, keep_base=False, keep_bits=True)   # no codes kept
    path = str(tmp_path / "mesh_bits.npz")
    one.save_state(path)
    back = ShardedIndex.restore_state(path, mesh)
    queries = rng.normal(size=(4, d)).astype(np.float32) * 3
    a_ids, _ = one.scan_route(queries, limit=32, approx=False)
    b_ids, _ = back.scan_route(queries, limit=32, approx=False)
    np.testing.assert_array_equal(a_ids, b_ids)


def test_distributed_facade_checkpoint_restore(tmp_path, rng):
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, k = 1200, 16, 5
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    queries = base[rng.integers(0, n, 4)] + \
        rng.normal(size=(4, d)).astype(np.float32) * 0.1
    cfg = _scan_cfg(d)
    s1 = DistributedEncryptedSystem(cfg, str(tmp_path / "ck"), d)
    try:
        s1.build(base)
        ids_a, _ = s1.search_batch(queries, k)
        s1.save_index()
    finally:
        s1.close()
    s2 = DistributedEncryptedSystem(cfg, str(tmp_path / "ck"), d)
    try:
        assert s2.restore_index() == n
        ids_b, _ = s2.search_batch(queries, k)
        np.testing.assert_array_equal(ids_a, ids_b)
    finally:
        s2.close()


def test_mesh_deletion_excluded_and_restored(tmp_path, rng):
    """Mesh deletion: tombstoned rows vanish from scan results without any
    rebuild, survive checkpoint restore (re-derived from the shard
    stores), and deletion composes with live insert."""
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, k = 1200, 16, 5
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    q = base[7:8] + rng.normal(size=(1, d)).astype(np.float32) * 0.01
    cfg = _scan_cfg(d)
    sys_ = DistributedEncryptedSystem(cfg, str(tmp_path / "del"), d)
    try:
        sys_.build(base, capacity=1600)
        ids0, _ = sys_.search_batch(q, k)
        assert 7 in ids0[0].tolist()
        sys_.delete(np.array([7]))
        ids1, _ = sys_.search_batch(q, k)
        assert 7 not in ids1[0].tolist(), "deleted row still returned"
        # deletion survives checkpoint + restore
        sys_.save_index()
    finally:
        sys_.close()
    back = DistributedEncryptedSystem(cfg, str(tmp_path / "del"), d)
    try:
        back.restore_index()
        ids2, _ = back.search_batch(q, k)
        assert 7 not in ids2[0].tolist(), "deletion lost across restore"
        # live insert after deletion: both effects visible
        new = (np.full((10, d), 25.0)
               + rng.normal(size=(10, d))).astype(np.float32)
        nids = back.insert_live(new)
        got, _ = back.search_batch(np.full((1, d), 25.0, np.float32), k)
        assert set(got[0].tolist()) <= set(nids.tolist())
        ids3, _ = back.search_batch(q, k)
        assert 7 not in ids3[0].tolist()
    finally:
        back.close()


def test_sharded_index_mark_deleted_all_paths(rng):
    """mark_deleted must mask rows in scan, probe route, AND the plaintext
    query path (all three step fns take the mask as a runtime input)."""
    n, d = 1024, 16
    base = rng.normal(size=(n, d)).astype(np.float32) * 3
    bank = coding.build_bank_from_sample(base[:512], 8, 2, 2, 2, 13)
    mesh = make_mesh()
    idx = ShardedIndex(mesh, bank, block_size=16)
    idx.build(base, keep_base=True, keep_bits=True, keep_codes=True)
    dead = np.arange(0, n, 7)
    idx.mark_deleted(dead)
    queries = base[dead[:4]].copy()   # query exactly at deleted points
    s_ids, _ = idx.scan_route(queries, limit=32, approx=False)
    assert not np.isin(s_ids, dead).any()
    r_ids, _ = idx.route(queries, probes=3, refinement_limit=64)
    assert not np.isin(r_ids[r_ids >= 0], dead).any()
    rr_ids, _ = idx.route(queries, probes=3, refinement_limit=64,
                          rerank_limit=32)
    assert not np.isin(rr_ids[rr_ids >= 0], dead).any()
    q_ids, _ = idx.query(queries, probes=3, refinement_limit=64, k=5)
    assert not np.isin(q_ids[q_ids >= 0], dead).any()


def test_mesh_background_migration_daemon(tmp_path, rng):
    """The background re-encryption daemon runs unmodified over the
    sharded store: after a key-only rotation, run_once migrates stale
    ciphertexts shard-transparently and serving results are unchanged."""
    import dataclasses

    from fspann.crypto.rotation import BackgroundReencryption
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, k = 800, 16, 5
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    queries = base[rng.integers(0, n, 4)] + \
        rng.normal(size=(4, d)).astype(np.float32) * 0.05
    sys_ = DistributedEncryptedSystem(_scan_cfg(d), str(tmp_path / "bg"), d)
    try:
        sys_.build(base)
        ids0, _ = sys_.search_batch(queries, k)
        v0 = sys_.km.current_version
        sys_.rotation.rotate_key_only()        # all ciphertexts now stale
        assert sys_.migration_remaining(v0) == n
        daemon = BackgroundReencryption(sys_.rotation, interval_s=60,
                                        batch=300)
        total = 0
        while sys_.migration_remaining(v0) > 0:
            moved = daemon.run_once()
            assert moved > 0
            total += moved
        assert total == n
        ids1, _ = sys_.search_batch(queries, k)
        np.testing.assert_array_equal(ids0, ids1)   # rotation orthogonal
    finally:
        sys_.close()


def test_mesh_undelete_roundtrip(tmp_path, rng):
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, k = 800, 16, 5
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    q = base[11:12] + rng.normal(size=(1, d)).astype(np.float32) * 0.01
    sys_ = DistributedEncryptedSystem(_scan_cfg(d), str(tmp_path / "ud"), d)
    try:
        sys_.build(base)
        sys_.delete(np.array([11]))
        ids1, _ = sys_.search_batch(q, k)
        assert 11 not in ids1[0].tolist()
        restored = sys_.undelete(np.array([11]))
        assert restored == [11]
        ids2, _ = sys_.search_batch(q, k)
        assert 11 in ids2[0].tolist()
    finally:
        sys_.close()


def test_mesh_checkpoint_after_live_insert(tmp_path, rng):
    """save_state after append_scan_rows must checkpoint the APPENDED rows
    (stale kept codes are dropped; codes repack from the live bit
    matrix)."""
    n, d = 800, 16
    base = rng.normal(size=(n + 100, d)).astype(np.float32) * 3
    bank = coding.build_bank_from_sample(base[:512], 8, 2, 2, 2, 13)
    mesh = make_mesh()
    idx = ShardedIndex(mesh, bank, block_size=16)
    idx.build(base[:n], keep_base=False, keep_bits=True, keep_codes=True,
              capacity=1024)
    idx.append_scan_rows(base[n:])
    path = str(tmp_path / "live_ck.npz")
    idx.save_state(path)
    back = ShardedIndex.restore_state(path, mesh)
    assert back.n == n + 100
    queries = base[n + 3:n + 7]        # query at appended points
    a_ids, _ = idx.scan_route(queries, limit=32, approx=False)
    b_ids, _ = back.scan_route(queries, limit=32, approx=False)
    np.testing.assert_array_equal(a_ids, b_ids)
    assert (a_ids[:, 0] == np.arange(n + 3, n + 7)).all()


def test_mesh_compact_storage_reclaims(tmp_path, rng):
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, k = 600, 16, 5
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    q = base[3:4]
    sys_ = DistributedEncryptedSystem(_scan_cfg(d), str(tmp_path / "cp"), d)
    try:
        sys_.build(base)
        before = sys_.size_bytes()
        # migrate HALF the points: v1 arenas keep live records plus the
        # superseded halves — compactable garbage in a live version
        sys_.rotate_and_migrate(np.arange(0, n, 2))
        bloated = sys_.size_bytes()
        assert bloated > before
        rep = sys_.compact_storage()
        assert rep["bytes_freed"] > 0
        assert rep["storage_bytes"] < bloated
        ids, _ = sys_.search_batch(q, k)   # still serving correctly
        assert 3 in ids[0].tolist()
    finally:
        sys_.close()


def test_mesh_adaptive_decrypt_budget(tmp_path, rng):
    """Mesh-path adaptive per-query decrypt budget: a saturated margin is
    result-identical to adaptive-off with the same decrypt count; a tight
    margin cuts the ids fanned out to the sharded AES open at near-equal
    recall (mirrors the single-chip tests in test_adaptive_decrypt.py)."""
    import dataclasses
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, q, k = 2048, 16, 8, 10
    centers = rng.normal(size=(16, d)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, n)] + \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 16, q)] + \
        rng.normal(size=(q, d)).astype(np.float32)
    cfg = _scan_cfg(d)
    sys_ = DistributedEncryptedSystem(cfg, str(tmp_path / "adapt"), d)

    decrypted = []
    orig = sys_.store.load_score_batch   # the fused stage-B entry point

    def counting(flat, *a, **kw):
        decrypted.append(int((np.asarray(flat) >= 0).sum()))
        return orig(flat, *a, **kw)

    sys_.store.load_score_batch = counting

    def with_margin(margin):
        sys_.cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, adaptive_decrypt_margin=margin)).validate()

    try:
        sys_.build(base)
        ids_off, d_off = sys_.search_batch(queries, k)
        with_margin(10_000)            # saturated: n_dec == L everywhere
        ids_sat, d_sat = sys_.search_batch(queries, k)
        np.testing.assert_array_equal(ids_off, ids_sat)
        np.testing.assert_allclose(d_off, d_sat)
        assert decrypted[1] == decrypted[0]
        with_margin(2)                 # tight: score-competitive set only
        ids_on, _ = sys_.search_batch(queries, k)
        assert decrypted[2] < decrypted[0]
        d2 = ((base[None] - queries[:, None]) ** 2).sum(-1)
        gt = np.argsort(d2, axis=1)[:, :k]
        r_off = sum(len(set(ids_off[i]) & set(gt[i])) for i in range(q))
        r_on = sum(len(set(ids_on[i]) & set(gt[i])) for i in range(q))
        assert r_on >= r_off - q        # near-equal recall
    finally:
        sys_.close()


def test_mesh_packed_scan_matches_unpacked(rng):
    """keep_bits="packed" (8x-less-HBM word layout, per-shard chunked
    unpack) must reproduce the unpacked mesh scan bit-exactly — including
    deletions and live inserts."""
    from fspann.ops import coding
    from fspann.parallel.sharded import ShardedIndex, make_mesh

    n, d = 1024, 16
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    bank = coding.build_bank_from_sample(base[:256], m=8, lam=2, tables=3,
                                         divisions=2, seed=13)
    mesh = make_mesh(8)
    a = ShardedIndex(mesh, bank, block_size=32)
    a.build(base, keep_base=False, keep_bits=True, capacity=n + 64)
    b = ShardedIndex(mesh, bank, block_size=32)
    b.build(base, keep_base=False, keep_bits="packed", capacity=n + 64)
    assert b.bits is None and b.words is not None
    np.testing.assert_array_equal(np.asarray(a.popc), np.asarray(b.popc))

    queries = base[rng.integers(0, n, 6)] + \
        rng.normal(size=(6, d)).astype(np.float32) * 0.05
    ia, sa = a.scan_route(queries, limit=48, approx=False)
    ib, sb = b.scan_route(queries, limit=48, approx=False)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(sa, sb)

    dead = np.asarray(ia[:, 0][:3], np.int64)
    a.mark_deleted(dead)
    b.mark_deleted(dead)
    ia, _ = a.scan_route(queries, limit=48, approx=False)
    ib, _ = b.scan_route(queries, limit=48, approx=False)
    np.testing.assert_array_equal(ia, ib)

    new = rng.normal(size=(40, d)).astype(np.float32) * 4
    np.testing.assert_array_equal(a.append_scan_rows(new),
                                  b.append_scan_rows(new))
    qn = new[7:9]
    ia, sa = a.scan_route(qn, limit=48, approx=False)
    ib, sb = b.scan_route(qn, limit=48, approx=False)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(sa, sb)
    assert ia[0, 0] == n + 7 and ia[1, 0] == n + 8


def test_mesh_packed_facade_and_checkpoint(tmp_path, rng):
    """DistributedEncryptedSystem with scan_packed='on': search equality
    with 'off', checkpoint/restore keeps the packed layout (save_state
    writes the words directly — no bit repack)."""
    import dataclasses
    from fspann.ops import hamming_scan as hs
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, q, k = 900, 16, 5, 10
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    queries = base[rng.integers(0, n, q)] + \
        rng.normal(size=(q, d)).astype(np.float32) * 0.05
    del hs

    def mk(packed, path):
        cfg = dataclasses.replace(_scan_cfg(d), runtime=dataclasses.replace(
            _scan_cfg(d).runtime, scan_packed=packed)).validate()
        s = DistributedEncryptedSystem(cfg, str(tmp_path / path), d)
        s.build(base)
        return s

    s_off = mk("off", "off")
    s_on = mk("on", "on")
    try:
        assert s_on.index.words is not None and s_on.index.bits is None
        assert s_off.index.bits is not None and s_off.index.words is None
        i0, d0 = s_off.search_batch(queries, k)
        i1, d1 = s_on.search_batch(queries, k)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_allclose(d0, d1, rtol=1e-6)

        s_on.save_index()
        s_on.index = None
        assert s_on.restore_index() == n
        assert s_on.index.words is not None and s_on.index.bits is None
        i2, d2 = s_on.search_batch(queries, k)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(d1, d2, rtol=1e-6)
    finally:
        s_off.close()
        s_on.close()


def test_mesh_search_batches_pipelined_matches_sequential(tmp_path, rng):
    """The pipelined mesh serving loop (dispatch batch i+1 before batch i's
    host consume, async D2H in flight) is result-identical to per-batch
    search_batch calls, in both scan and probe routing modes."""
    from fspann.config import SystemConfig, PaperConfig, RuntimeConfig
    from fspann.parallel.serving import DistributedEncryptedSystem

    n, d, k = 1536, 16, 8
    base = rng.normal(size=(n, d)).astype(np.float32) * 3
    batches = [base[rng.integers(0, n, 5)] +
               rng.normal(size=(5, d)).astype(np.float32) * 0.05
               for _ in range(3)]

    for mode, extra in (("scan", dict(adaptive_decrypt_margin=6,
                                      adaptive_decrypt_anchor=8,
                                      adaptive_decrypt_floor=32)),
                        ("probe", {})):
        cfg = SystemConfig(
            paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
            runtime=RuntimeConfig(refinement_limit=256,
                                  max_global_candidates=256,
                                  default_probes=4, block_size=32,
                                  routing_mode=mode, **extra)).validate()
        sys_ = DistributedEncryptedSystem(cfg, str(tmp_path / f"db_{mode}"),
                                          d)
        try:
            sys_.build(base)
            seq = [sys_.search_batch(q, k) for q in batches]
            piped = sys_.search_batches(batches, k)
            assert len(piped) == len(seq)
            for (i1, d1), (i2, d2) in zip(seq, piped):
                np.testing.assert_array_equal(i1, i2)
                np.testing.assert_allclose(d1, d2, rtol=1e-6)
        finally:
            sys_.close()


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multi-device mesh")
@pytest.mark.parametrize("layout", [True, "packed"])
def test_host_merge_matches_ici_merge(rng, layout):
    """merge_backend="host" (sharded per-shard top-Ls + host 2-key merge,
    no collective in the query step) is bit-identical to the device
    all_gather merge — packed and unpacked layouts, with tombstones and
    live-insert headroom in play."""
    n, d, q, L = 1500, 12, 5, 64
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    queries = base[:q] + 0.05

    mesh = make_mesh()
    bank = coding.build_bank_from_sample(base[:512], m=8, lam=2, tables=3,
                                         divisions=2, seed=5)
    idx = ShardedIndex(mesh, bank, block_size=32)
    idx.build(base, keep_base=False, keep_bits=layout, capacity=n + 128)
    idx.mark_deleted(np.arange(0, n, 97))       # scattered tombstones

    ids_dev, sc_dev = idx.scan_route(queries, limit=L, approx=False)
    idx.merge_backend = "host"
    ids_host, sc_host = idx.scan_route(queries, limit=L, approx=False)
    np.testing.assert_array_equal(np.asarray(ids_dev), ids_host)
    np.testing.assert_array_equal(np.asarray(sc_dev), sc_host)

    # approx path too (same approx_max_k inputs -> same outputs per shard)
    idx.merge_backend = "device"
    a_ids, a_sc = idx.scan_route(queries, limit=L, approx=True)
    idx.merge_backend = "host"
    b_ids, b_sc = idx.scan_route(queries, limit=L, approx=True)
    np.testing.assert_array_equal(np.asarray(a_ids), b_ids)
    np.testing.assert_array_equal(np.asarray(a_sc), b_sc)
