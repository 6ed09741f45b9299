import numpy as np
import jax.numpy as jnp

from fspann.ops import refine


def test_refine_matches_numpy(rng):
    q, r, d, k = 6, 50, 16, 5
    qv = rng.normal(size=(q, d)).astype(np.float32)
    cv = rng.normal(size=(q, r, d)).astype(np.float32)
    ids = rng.permutation(10_000)[: q * r].reshape(q, r).astype(np.int32)
    valid = rng.random((q, r)) > 0.2
    out = refine.refine(jnp.asarray(qv), jnp.asarray(cv), jnp.asarray(ids),
                        jnp.asarray(valid), k)
    for qi in range(q):
        d2 = ((cv[qi] - qv[qi]) ** 2).sum(-1)
        d2[~valid[qi]] = np.inf
        order = np.argsort(d2, kind="stable")[:k]
        exp_d = np.sqrt(d2[order])
        np.testing.assert_allclose(np.asarray(out.distances[qi]), exp_d,
                                   rtol=1e-5)
        finite = np.isfinite(exp_d)
        np.testing.assert_array_equal(np.asarray(out.ids[qi])[finite],
                                      ids[qi][order][finite])
        assert int(out.n_scored[qi]) == valid[qi].sum()


def test_refine_all_invalid():
    out = refine.refine(jnp.zeros((2, 4)), jnp.zeros((2, 3, 4)),
                        jnp.zeros((2, 3), jnp.int32),
                        jnp.zeros((2, 3), bool), 2)
    assert np.all(np.asarray(out.ids) == -1)
    assert np.all(np.isinf(np.asarray(out.distances)))


def test_bruteforce_topk(rng):
    n, d, q, k = 1000, 24, 8, 10
    base = rng.normal(size=(n, d)).astype(np.float32)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    ids, dist = refine.bruteforce_topk(base, qs, k, chunk=300)
    for qi in range(q):
        d2 = ((base - qs[qi]) ** 2).sum(-1)
        order = np.argsort(d2, kind="stable")[:k]
        np.testing.assert_allclose(dist[qi], np.sqrt(d2[order]), rtol=1e-4)
        # ids may differ on exact ties; distances must match
        np.testing.assert_allclose(np.sqrt(d2[ids[qi]]), np.sqrt(d2[order]),
                                   rtol=1e-4)


def test_host_refine_scored_matches_unfused_oracle(rng):
    """_host_refine_scored (stage C from fused C-loop norms+dots) must equal
    the vector-based _host_refine oracle bit-for-bit when fed consistent
    inputs."""
    from fspann.query.service import _host_refine, _host_refine_scored
    import numpy as np

    q, r, d, k = 5, 64, 16, 10
    qvecs = rng.normal(size=(q, d)).astype(np.float32)
    cand = rng.normal(size=(q, r, d)).astype(np.float32)
    ids = rng.integers(0, 1000, size=(q, r)).astype(np.int64)
    valid = rng.random(size=(q, r)) > 0.2
    dots = np.einsum("qrd,qd->qr", cand, qvecs).astype(np.float32)
    c2 = np.einsum("qrd,qrd->qr", cand, cand).astype(np.float32)
    i1, d1, n1 = _host_refine(qvecs, cand, ids, valid, k, c2=c2)
    i2, d2, n2 = _host_refine_scored(qvecs, dots, c2, ids, valid, k)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    np.testing.assert_array_equal(n1, n2)
