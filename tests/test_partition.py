import numpy as np
import jax.numpy as jnp

from fspann.ops import partition
from oracles import oracle_partitions


def build_inputs(rng, g=3, n=200, w=2, key_range=1 << 40):
    keys = rng.integers(0, key_range, size=(g, n)).astype(np.int64)
    codes = rng.integers(0, 1 << 32, size=(g, n, w), dtype=np.uint64).astype(np.uint32)
    return keys, codes


def test_build_matches_oracle(rng):
    for n, block in [(200, 64), (256, 64), (64, 64), (10, 64), (130, 32)]:
        keys, codes = build_inputs(rng, g=3, n=n)
        table = partition.build_partitions(jnp.asarray(keys), jnp.asarray(codes),
                                           block_size=block)
        p = -(-n // block)
        assert table.ids.shape == (3, p, block)
        for g in range(3):
            parts = oracle_partitions(keys[g], np.arange(n), block)
            assert len(parts) == p
            for pi, part in enumerate(parts):
                assert int(table.min_key[g, pi]) == part["min"]
                assert int(table.max_key[g, pi]) == part["max"]
                cnt = int(table.counts[g, pi])
                assert cnt == len(part["ids"])
                got_ids = sorted(int(x) for x in np.asarray(table.ids[g, pi])[:cnt])
                assert got_ids == sorted(part["ids"])
                # padding
                assert np.all(np.asarray(table.ids[g, pi])[cnt:] == -1)
                np.testing.assert_array_equal(
                    np.asarray(table.rep_codes[g, pi]), codes[g, part["rep_id"]])


def test_duplicate_keys_deterministic(rng):
    keys = np.zeros((1, 100), np.int64)  # all equal keys
    codes = rng.integers(0, 1 << 32, size=(1, 100, 1), dtype=np.uint64).astype(np.uint32)
    t1 = partition.build_partitions(jnp.asarray(keys), jnp.asarray(codes), 32)
    t2 = partition.build_partitions(jnp.asarray(keys), jnp.asarray(codes), 32)
    np.testing.assert_array_equal(np.asarray(t1.ids), np.asarray(t2.ids))
    # ties break by id ascending
    np.testing.assert_array_equal(np.asarray(t1.ids[0, 0]), np.arange(32))
