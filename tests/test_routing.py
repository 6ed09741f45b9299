import numpy as np
import jax.numpy as jnp

from fspann.ops import coding, partition, routing
from oracles import (oracle_find_nearest, oracle_partitions, oracle_route)


def build_index(rng, n=500, d=24, m=10, lam=2, tables=2, divisions=2, block=16,
                seed=3):
    base = rng.normal(size=(n, d)).astype(np.float32) * 4
    bank = coding.build_bank_from_sample(base[:256], m, lam, tables, divisions,
                                         seed)
    codes, keys = coding.encode(jnp.asarray(base), bank)
    codes_gn = jnp.transpose(codes, (1, 0, 2))   # [G, N, W]
    keys_gn = jnp.transpose(keys, (1, 0))        # [G, N]
    table = partition.build_partitions(keys_gn, codes_gn, block)
    return base, bank, codes, keys, table


def oracle_setup(base, bank, codes, keys, block):
    """Build the oracle-side partition lists + rep code bit arrays."""
    n = base.shape[0]
    g = bank.g
    codes_np = np.asarray(codes)      # [N, G, W]
    keys_np = np.asarray(keys)        # [N, G]
    nbits = bank.code_bits
    # unpack bits from packed words
    def unpack(words):
        out = np.zeros(words.shape[:-1] + (words.shape[-1] * 32,), np.uint8)
        for wi in range(words.shape[-1]):
            for b in range(32):
                out[..., wi * 32 + b] = (words[..., wi] >> np.uint32(31 - b)) & 1
        return out[..., :nbits]
    bits = unpack(codes_np)           # [N, G, nbits]
    group_parts, group_rep_bits = [], []
    for gi in range(g):
        parts = oracle_partitions(keys_np[:, gi], np.arange(n), block)
        rep_bits = np.stack([bits[p["rep_id"], gi] for p in parts])
        group_parts.append(parts)
        group_rep_bits.append(rep_bits)
    return group_parts, group_rep_bits, bits


def test_find_center_matches_oracle(rng):
    base, bank, codes, keys, table = build_index(rng)
    group_parts, _, _ = oracle_setup(base, bank, codes, keys, 16)
    queries = rng.normal(size=(40, 24)).astype(np.float32) * 4
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    centers = np.asarray(routing.find_center(table, qk))
    qk_np = np.asarray(qk)
    for qi in range(queries.shape[0]):
        for gi in range(bank.g):
            expected = oracle_find_nearest(group_parts[gi], int(qk_np[qi, gi]))
            got = int(centers[qi, gi])
            if got != expected:
                # equal-range blocks: any containing block is valid
                p_exp = group_parts[gi][expected]
                p_got = group_parts[gi][got]
                assert (p_got["min"] <= qk_np[qi, gi] <= p_got["max"] and
                        p_exp["min"] <= qk_np[qi, gi] <= p_exp["max"]), (
                    f"center mismatch q={qi} g={gi}: got {got} want {expected}")


def test_find_center_edges():
    """Key below all / above all / inside / in a gap."""
    min_key = jnp.asarray([[10, 30, 60]], jnp.int64)
    max_key = jnp.asarray([[19, 40, 70]], jnp.int64)
    table = partition.PartitionTable(
        min_key, max_key,
        jnp.zeros((1, 3, 1), jnp.uint32),
        jnp.zeros((1, 3, 4), jnp.int32),
        jnp.full((1, 3), 4, jnp.int32))
    qkeys = jnp.asarray([[0], [100], [35], [22], [55], [10], [70]], jnp.int64)
    got = np.asarray(routing.find_center(table, qkeys))[:, 0]
    #       below  above inside gap(19/30:3<=8->left) gap(40/60:15>5->right)
    np.testing.assert_array_equal(got, [0, 2, 1, 0, 2, 0, 2])


def test_route_matches_oracle(rng):
    base, bank, codes, keys, table = build_index(rng, n=400, block=16)
    block = 16
    group_parts, group_rep_bits, bits = oracle_setup(base, bank, codes, keys, block)
    queries = rng.normal(size=(20, 24)).astype(np.float32) * 4
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    tomb = jnp.zeros(base.shape[0], bool)
    limit = 200
    res = routing.route(table, qc, qk, tomb, max_probes=3,
                        refinement_limit=limit)
    qc_np, qk_np = np.asarray(qc), np.asarray(qk)
    nbits = bank.code_bits
    for qi in range(queries.shape[0]):
        qbits_per_group = []
        for gi in range(bank.g):
            words = qc_np[qi, gi]
            qbits = np.zeros(nbits, np.uint8)
            for p in range(nbits):
                qbits[p] = (words[p // 32] >> np.uint32(31 - p % 32)) & 1
            qbits_per_group.append(qbits)
        expected = oracle_route(group_parts, group_rep_bits, qbits_per_group,
                                qk_np[qi], max_probes=3, limit=limit)
        got_ids = [int(x) for x in np.asarray(res.ids[qi]) if x >= 0]
        got_scores = [int(s) for x, s in zip(np.asarray(res.ids[qi]),
                                             np.asarray(res.scores[qi])) if x >= 0]
        exp_ids = [pid for pid, _ in expected]
        exp_scores = [s for _, s in expected]
        assert got_ids == exp_ids, f"q={qi}"
        assert got_scores == exp_scores, f"q={qi}"


def test_route_respects_tombstones(rng):
    base, bank, codes, keys, table = build_index(rng, n=300, block=16)
    queries = base[:5] + 0.01  # near-duplicates of known points
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    no_tomb = jnp.zeros(base.shape[0], bool)
    res0 = routing.route(table, qc, qk, no_tomb, 3, 100)
    # tombstone everything that was returned for query 0
    dead_ids = [int(x) for x in np.asarray(res0.ids[0]) if x >= 0][:10]
    tomb = np.zeros(base.shape[0], bool)
    tomb[dead_ids] = True
    res1 = routing.route(table, qc, qk, jnp.asarray(tomb), 3, 100)
    got = {int(x) for x in np.asarray(res1.ids[0]) if x >= 0}
    assert not (got & set(dead_ids))


def test_route_probes_exceed_partitions(rng):
    """max_probes > number of partitions: walk exhausts the line cleanly and
    every live point is a candidate."""
    base, bank, codes, keys, table = build_index(rng, n=60, block=16)
    p = table.num_partitions
    queries = rng.normal(size=(4, 24)).astype(np.float32) * 4
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    res = routing.route(table, qc, qk, jnp.zeros(60, bool),
                        max_probes=p + 5, refinement_limit=100)
    ids = np.asarray(res.ids)
    for qi in range(4):
        live = sorted(int(x) for x in ids[qi] if x >= 0)
        assert live == list(range(60))


def test_route_single_partition(rng):
    """Corpus smaller than one block: one partition, probes clamp."""
    base, bank, codes, keys, table = build_index(rng, n=10, block=16)
    assert table.num_partitions == 1
    queries = rng.normal(size=(2, 24)).astype(np.float32)
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    res = routing.route(table, qc, qk, jnp.zeros(10, bool), 5, 50)
    ids = np.asarray(res.ids)
    for qi in range(2):
        assert sorted(int(x) for x in ids[qi] if x >= 0) == list(range(10))


def test_route_dedupes_min_score(rng):
    base, bank, codes, keys, table = build_index(rng, n=300, block=16)
    queries = rng.normal(size=(8, 24)).astype(np.float32) * 4
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    tomb = jnp.zeros(base.shape[0], bool)
    res = routing.route(table, qc, qk, tomb, 4, 500)
    ids = np.asarray(res.ids)
    scores = np.asarray(res.scores)
    for qi in range(8):
        live = ids[qi][ids[qi] >= 0]
        assert len(live) == len(set(live.tolist())), "duplicate ids returned"
        s = scores[qi][ids[qi] >= 0]
        assert np.all(np.diff(s) >= 0), "scores not ascending"
        assert int(res.n_unique[qi]) == len(live) or len(live) == 500


def test_route_matches_oracle_lam3(rng):
    """Route parity at lambda=3 (72-bit codes, W=3 words, key truncation to
    the first 63 bits — codes longer than the key still rank by full
    Hamming)."""
    base, bank, codes, keys, table = build_index(rng, n=300, m=12, lam=3,
                                                 block=16)
    group_parts, group_rep_bits, bits = oracle_setup(base, bank, codes, keys, 16)
    queries = rng.normal(size=(10, 24)).astype(np.float32) * 4
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    res = routing.route(table, qc, qk, jnp.zeros(300, bool), 3, 150)
    qc_np, qk_np = np.asarray(qc), np.asarray(qk)
    nbits = bank.code_bits
    assert nbits == 36 * 1 or nbits == 36  # m*lam = 36 -> W=2
    for qi in range(10):
        qbits_per_group = []
        for gi in range(bank.g):
            words = qc_np[qi, gi]
            qbits = np.zeros(nbits, np.uint8)
            for p in range(nbits):
                qbits[p] = (words[p // 32] >> np.uint32(31 - p % 32)) & 1
            qbits_per_group.append(qbits)
        expected = oracle_route(group_parts, group_rep_bits, qbits_per_group,
                                qk_np[qi], max_probes=3, limit=150)
        got = [(int(x), int(s)) for x, s in zip(np.asarray(res.ids[qi]),
                                                np.asarray(res.scores[qi]))
               if x >= 0]
        assert got == expected, f"q={qi}"


def test_route_matches_oracle_wide_codes(rng):
    """m=24, lam=3: 72-bit codes exceed the 63-bit key (truncation path)."""
    base, bank, codes, keys, table = build_index(rng, n=200, m=24, lam=3,
                                                 block=16)
    assert bank.code_bits == 72 and bank.code_words == 3
    group_parts, group_rep_bits, _ = oracle_setup(base, bank, codes, keys, 16)
    queries = rng.normal(size=(6, 24)).astype(np.float32) * 4
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    res = routing.route(table, qc, qk, jnp.zeros(200, bool), 3, 120)
    qc_np, qk_np = np.asarray(qc), np.asarray(qk)
    for qi in range(6):
        qbits_per_group = []
        for gi in range(bank.g):
            words = qc_np[qi, gi]
            qbits = np.zeros(72, np.uint8)
            for p in range(72):
                qbits[p] = (words[p // 32] >> np.uint32(31 - p % 32)) & 1
            qbits_per_group.append(qbits)
        expected = oracle_route(group_parts, group_rep_bits, qbits_per_group,
                                qk_np[qi], max_probes=3, limit=120)
        got = [(int(x), int(s)) for x, s in zip(np.asarray(res.ids[qi]),
                                                np.asarray(res.scores[qi]))
               if x >= 0]
        assert got == expected, f"q={qi}"


def _popcount_bits(words_row):
    """Total set bits of a uint32 word array (numpy oracle)."""
    return int(np.unpackbits(words_row.view(np.uint8)).sum())


def test_rerank_matches_numpy_oracle(rng):
    base, bank, codes, keys, table = build_index(rng, n=400, block=16)
    queries = rng.normal(size=(12, 24)).astype(np.float32) * 4
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    tomb = jnp.zeros(base.shape[0], bool)
    res = routing.route(table, qc, qk, tomb, max_probes=3,
                        refinement_limit=200)
    limit = 40
    rer = routing.rerank(jnp.asarray(codes), qc, res, limit)
    codes_np = np.asarray(codes)    # [N, G, W]
    qc_np = np.asarray(qc)
    ids_np = np.asarray(res.ids)
    for qi in range(12):
        cand = [int(x) for x in ids_np[qi] if x >= 0]
        fine = {c: _popcount_bits(np.bitwise_xor(codes_np[c], qc_np[qi]))
                for c in cand}
        exp = sorted(cand, key=lambda c: (fine[c], c))[:limit]
        got_ids = [int(x) for x in np.asarray(rer.ids[qi]) if x >= 0]
        got_scores = [int(s) for x, s in zip(np.asarray(rer.ids[qi]),
                                             np.asarray(rer.scores[qi]))
                      if x >= 0]
        assert got_ids == exp, f"q={qi}"
        assert got_scores == [fine[c] for c in exp], f"q={qi}"
        assert int(rer.n_unique[qi]) == min(int(res.n_unique[qi]), limit)


def test_rerank_keeps_pads_when_underfull(rng):
    """Fewer live candidates than the limit: pads stay -1 / INF at the end."""
    base, bank, codes, keys, table = build_index(rng, n=60, block=16)
    queries = rng.normal(size=(3, 24)).astype(np.float32)
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    res = routing.route(table, qc, qk, jnp.zeros(60, bool), 2, 500)
    rer = routing.rerank(jnp.asarray(codes), qc, res, 500)
    ids = np.asarray(rer.ids)
    scores = np.asarray(rer.scores)
    for qi in range(3):
        n = int(rer.n_unique[qi])
        assert (ids[qi, :n] >= 0).all()
        assert (ids[qi, n:] == -1).all()
        assert np.all(np.diff(scores[qi, :n]) >= 0)


def test_route_rerank_fused_equals_two_stage(rng):
    """route_rerank == rerank(route(un-truncated)) bit-exactly: the top_k
    over the id-sorted dedup array reproduces the (fine, id) tie-break."""
    base, bank, codes, keys, table = build_index(rng, n=400, block=16)
    queries = rng.normal(size=(10, 24)).astype(np.float32) * 4
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    tomb = jnp.zeros(base.shape[0], bool)
    # flat probed width = G * probes * block = 4*3*16 = 192 < 400 -> no
    # truncation in the wide route, so pools are identical
    wide = routing.route(table, qc, qk, tomb, max_probes=3,
                         refinement_limit=400)
    limit = 50
    two = routing.rerank(jnp.asarray(codes), qc, wide, limit)
    fused = routing.route_rerank(table, qc, qk, tomb, jnp.asarray(codes),
                                 max_probes=3, limit=limit)
    np.testing.assert_array_equal(np.asarray(two.ids), np.asarray(fused.ids))
    live = np.asarray(two.ids) >= 0
    np.testing.assert_array_equal(np.asarray(two.scores)[live],
                                  np.asarray(fused.scores)[live])
    np.testing.assert_array_equal(np.asarray(two.n_unique),
                                  np.asarray(fused.n_unique))


def test_route_rerank_respects_tombstones(rng):
    base, bank, codes, keys, table = build_index(rng, n=300, block=16)
    queries = base[:4] + 0.01
    qc, qk = coding.encode(jnp.asarray(queries), bank)
    res0 = routing.route_rerank(table, qc, qk, jnp.zeros(300, bool),
                                jnp.asarray(codes), 3, 80)
    dead = [int(x) for x in np.asarray(res0.ids[0]) if x >= 0][:8]
    tomb = np.zeros(300, bool)
    tomb[dead] = True
    res1 = routing.route_rerank(table, qc, qk, jnp.asarray(tomb),
                                jnp.asarray(codes), 3, 80)
    got = {int(x) for x in np.asarray(res1.ids[0]) if x >= 0}
    assert not (got & set(dead))
