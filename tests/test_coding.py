import numpy as np
import jax.numpy as jnp

from fspann.ops import coding
from oracles import oracle_h, oracle_code_bits, oracle_pack, oracle_key


def make_bank(rng, d=16, m=6, lam=2, tables=2, divisions=2, seed=7):
    sample = rng.normal(size=(256, d)).astype(np.float32) * 10
    bank = coding.build_bank_from_sample(sample, m, lam, tables, divisions, seed)
    return bank, sample


def test_bank_shapes_and_determinism(rng):
    bank, sample = make_bank(rng)
    g = bank.g
    assert bank.alpha.shape == (g, bank.m, 16)
    assert bank.omega.shape == (g, bank.m)
    # rows normalized
    norms = np.linalg.norm(np.asarray(bank.alpha), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    assert np.all(np.asarray(bank.omega) > 0)
    assert np.all(np.asarray(bank.r) >= 0)
    assert np.all(np.asarray(bank.r) <= np.asarray(bank.omega))
    # deterministic rebuild
    bank2 = coding.build_bank_from_sample(sample, bank.m, bank.lam,
                                          bank.tables, bank.divisions, 7)
    np.testing.assert_array_equal(np.asarray(bank.alpha), np.asarray(bank2.alpha))
    np.testing.assert_array_equal(np.asarray(bank.omega), np.asarray(bank2.omega))


def test_bank_from_stats_roundtrip(rng):
    bank, _ = make_bank(rng)
    rebuilt = coding.bank_from_stats(np.asarray(bank.omega), np.asarray(bank.r),
                                     bank.d, bank.m, bank.lam, bank.tables,
                                     bank.divisions, bank.seed)
    np.testing.assert_array_equal(np.asarray(bank.alpha), np.asarray(rebuilt.alpha))
    np.testing.assert_array_equal(np.asarray(bank.omega), np.asarray(rebuilt.omega))
    np.testing.assert_array_equal(np.asarray(bank.r), np.asarray(rebuilt.r))


def test_h_matches_oracle(rng):
    bank, _ = make_bank(rng)
    x = rng.normal(size=(64, 16)).astype(np.float32) * 5
    h = np.asarray(coding.project_h(jnp.asarray(x), bank))
    ho = oracle_h(x, np.asarray(bank.alpha), np.asarray(bank.r),
                  np.asarray(bank.omega))
    # f32 vs f64 floor can differ exactly at bucket boundaries; allow off-by-one
    # in < 0.1% of entries and exact match elsewhere.
    diff = np.abs(h.astype(np.int64) - ho.astype(np.int64))
    assert (diff > 1).sum() == 0
    assert (diff == 1).mean() < 1e-3
    assert h.dtype == np.int32


def _pack_and_key_cases():
    return [(6, 2), (6, 3), (24, 2), (24, 3), (28, 2), (16, 1)]


def test_pack_codes_vs_oracle(rng):
    for m, lam in _pack_and_key_cases():
        h = rng.integers(-1000, 1000, size=(32, 3, m)).astype(np.int32)
        packed = np.asarray(coding.pack_codes(jnp.asarray(h), m, lam))
        bits = oracle_code_bits(h, m, lam)
        expected = oracle_pack(bits)
        np.testing.assert_array_equal(packed, expected, err_msg=f"m={m},lam={lam}")
        assert packed.shape[-1] == (m * lam + 31) // 32


def test_keys_vs_oracle(rng):
    for m, lam in _pack_and_key_cases():
        h = rng.integers(-1000, 1000, size=(40, 2, m)).astype(np.int32)
        bits = oracle_code_bits(h, m, lam)
        packed = coding.pack_codes(jnp.asarray(h), m, lam)
        keys = np.asarray(coding.keys_from_codes(packed))
        expected = oracle_key(bits)
        np.testing.assert_array_equal(keys, expected, err_msg=f"m={m},lam={lam}")
        assert np.all(keys >= 0)


def test_key_order_matches_code_prefix_order(rng):
    """Sorting by int64 key == lexicographic order of the first 63 code bits."""
    m, lam = 24, 2  # 48 bits -> full code inside the key
    h = rng.integers(-50, 50, size=(200, 1, m)).astype(np.int32)
    bits = oracle_code_bits(h, m, lam)[:, 0, :]
    packed = coding.pack_codes(jnp.asarray(h), m, lam)
    keys = np.asarray(coding.keys_from_codes(packed))[:, 0]
    order_key = np.argsort(keys, kind="stable")
    # lexicographic on bit strings
    as_str = ["".join(map(str, row)) for row in bits]
    order_lex = np.argsort(as_str, kind="stable")
    np.testing.assert_array_equal(keys[order_key], keys[order_lex])


def test_encode_end_to_end(rng):
    bank, _ = make_bank(rng, d=32, m=24, lam=2, tables=3, divisions=2)
    x = rng.normal(size=(100, 32)).astype(np.float32)
    codes, keys = coding.encode(jnp.asarray(x), bank)
    assert codes.shape == (100, 6, 2)
    assert keys.shape == (100, 6)
    assert codes.dtype == jnp.uint32
    assert keys.dtype == jnp.int64
    # same vector -> same code (deterministic)
    c2, k2 = coding.encode(jnp.asarray(x), bank)
    np.testing.assert_array_equal(np.asarray(codes), np.asarray(c2))


def test_encode_numpy_matches_device_encode(rng):
    """Host (numpy) and device encode agree except at rare f32 bucket
    boundaries (different matmul summation orders); packing/keys are exact
    given H."""
    bank, _ = make_bank(rng, d=32, m=24, lam=2, tables=3, divisions=2)
    x = rng.normal(size=(500, 32)).astype(np.float32)
    nc, nk = coding.encode_numpy(x, bank)
    jc, jk = coding.encode(jnp.asarray(x), bank)
    match = (np.asarray(jc) == nc).mean()
    assert match > 0.999, f"code word agreement {match}"
    # keys derive exactly from codes
    np.testing.assert_array_equal(
        nk, np.asarray(coding.keys_from_codes(jnp.asarray(nc))))
    # packing path identical given identical H
    h = np.asarray(coding.project_h(jnp.asarray(x), bank))
    from oracles import oracle_code_bits, oracle_pack
    expected = oracle_pack(oracle_code_bits(h, bank.m, bank.lam))
    np.testing.assert_array_equal(np.asarray(jc), expected)
