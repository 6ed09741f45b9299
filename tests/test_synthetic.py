"""LSH-hard corpus generator invariants (io/synthetic.py)."""

import numpy as np

from fspann.io.synthetic import easy_corpus, lsh_hard_corpus


def test_shapes_and_determinism():
    b1, q1 = lsh_hard_corpus(5000, 32, 17, seed=7)
    b2, q2 = lsh_hard_corpus(5000, 32, 17, seed=7)
    assert b1.shape == (5000, 32) and q1.shape == (17, 32)
    assert b1.dtype == np.float32 and q1.dtype == np.float32
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(q1, q2)
    b3, _ = lsh_hard_corpus(5000, 32, 17, seed=8)
    assert not np.array_equal(b1, b3)
    assert np.isfinite(b1).all() and np.isfinite(q1).all()


def test_hard_is_harder_than_easy():
    """Relative contrast (d_NN / d_mean) must be materially lower on the
    hard instance — the property that makes LSH routing non-trivial."""
    def contrast(base, queries, k=10):
        rc = []
        for q in queries[:8]:
            d2 = ((base - q) ** 2).sum(axis=1)
            d2.sort()
            rc.append(np.sqrt(d2[k - 1]) / np.sqrt(d2.mean()))
        return float(np.mean(rc))

    bh, qh = lsh_hard_corpus(20000, 64, 8, seed=3)
    be, qe = easy_corpus(20000, 64, 8, seed=3, n_clusters=256)
    ch, ce = contrast(bh, qh), contrast(be, qe)
    # d_NN/d_mean closer to 1 = NN buried in the bulk = harder
    assert ch > ce * 1.15, (ch, ce)


def test_cluster_sizes_heavy_tailed():
    from fspann.io.synthetic import _zipf_sizes
    rng = np.random.default_rng(0)
    sizes = _zipf_sizes(rng, 200, 100_000, a=1.1)
    assert sizes.sum() == 100_000
    assert sizes.min() >= 1
    # heavy tail: the largest cluster dwarfs the median
    assert sizes.max() > 10 * np.median(sizes)


def test_glove_like_properties():
    from fspann.io.synthetic import glove_like_corpus

    base, queries = glove_like_corpus(5000, 100, 50, seed=7)
    b2, q2 = glove_like_corpus(5000, 100, 50, seed=7)
    np.testing.assert_array_equal(base, b2)       # deterministic
    np.testing.assert_array_equal(queries, q2)
    assert base.shape == (5000, 100) and queries.shape == (50, 100)
    # heavy-tailed norms (lognormal): p95/p50 norm ratio well above 1
    norms = np.linalg.norm(base, axis=1)
    assert np.percentile(norms, 95) / np.percentile(norms, 50) > 1.8
    # anisotropy: top principal direction carries far more variance than
    # the median one
    cov_diag = np.sort(np.linalg.eigvalsh(np.cov(base[:4000].T)))[::-1]
    assert cov_diag[0] > 20 * cov_diag[50]
    # queries are held-out draws, not corpus rows
    assert not any((base == q).all(axis=1).any() for q in queries[:5])


def test_redcaps_like_properties():
    from fspann.io.synthetic import redcaps_like_corpus

    base, queries = redcaps_like_corpus(5000, 512, 50, seed=7)
    assert base.shape == (5000, 512) and queries.shape == (50, 512)
    # unit norm (CLIP convention)
    np.testing.assert_allclose(np.linalg.norm(base, axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(queries, axis=1), 1.0,
                               atol=1e-4)
    # distance concentration: pairwise cosines cluster in a tight band, so
    # L2 distances concentrate around sqrt(2) — the LSH-hostile regime
    rng = np.random.default_rng(0)
    a = base[rng.integers(0, 5000, 500)]
    b = base[rng.integers(0, 5000, 500)]
    cos = np.einsum("ij,ij->i", a, b)
    assert cos.std() < 0.1           # tight band = distance concentration
    d = np.linalg.norm(a - b, axis=1)
    assert d.std() / d.mean() < 0.05
