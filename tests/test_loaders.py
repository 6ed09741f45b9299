"""Loader + ground-truth tests (reference loader/ module suite)."""

import numpy as np
import pytest

from fspann.io import groundtruth, loaders


def write_fvecs(path, arr):
    n, d = arr.shape
    out = np.empty((n, 1 + d), "<f4")
    out[:, 0:1] = np.frombuffer(np.full(n, d, "<i4").tobytes(), "<f4"
                                ).reshape(n, 1)
    out[:, 1:] = arr
    out.tofile(path)


def write_ivecs(path, arr):
    n, k = arr.shape
    out = np.empty((n, 1 + k), "<i4")
    out[:, 0] = k
    out[:, 1:] = arr
    out.tofile(path)


def write_bvecs(path, arr):
    n, d = arr.shape
    with open(path, "wb") as f:
        for row in arr:
            f.write(np.int32(d).tobytes())
            f.write(row.astype(np.uint8).tobytes())


def test_fvecs_roundtrip(tmp_path, rng):
    arr = rng.normal(size=(50, 8)).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    write_fvecs(p, arr)
    got = loaders.read_fvecs(p)
    np.testing.assert_array_equal(np.asarray(got), arr)
    # dispatch by extension
    np.testing.assert_array_equal(np.asarray(loaders.load_vectors(p)), arr)


def test_bvecs_roundtrip(tmp_path, rng):
    arr = rng.integers(0, 256, (30, 16)).astype(np.uint8)
    p = str(tmp_path / "x.bvecs")
    write_bvecs(p, arr)
    got = loaders.read_bvecs(p)
    np.testing.assert_array_equal(np.asarray(got), arr)


def test_ivecs_roundtrip(tmp_path, rng):
    arr = rng.integers(0, 1000, (20, 10)).astype(np.int32)
    p = str(tmp_path / "gt.ivecs")
    write_ivecs(p, arr)
    np.testing.assert_array_equal(np.asarray(loaders.read_ivecs(p)), arr)


def test_csv_tolerant(tmp_path):
    p = str(tmp_path / "x.csv")
    with open(p, "w") as f:
        f.write("﻿col1,col2\n# comment\n1.5,2.5\n\n3.0,4.0\n")
    got = loaders.read_csv(p)
    np.testing.assert_allclose(got, [[1.5, 2.5], [3.0, 4.0]])


def test_truncated_fvecs_rejected(tmp_path, rng):
    arr = rng.normal(size=(10, 8)).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    write_fvecs(p, arr)
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-7])
    with pytest.raises(ValueError, match="not a multiple"):
        loaders.read_fvecs(p)


def test_unknown_extension(tmp_path):
    p = str(tmp_path / "x.weird")
    open(p, "w").write("")
    with pytest.raises(ValueError, match="unsupported"):
        loaders.load_vectors(p)


def test_stream_batches(rng):
    data = rng.normal(size=(25, 4)).astype(np.float64)
    batches = list(loaders.stream_batches(data, 10))
    assert [b[0] for b in batches] == [0, 10, 20]
    assert [len(b[1]) for b in batches] == [10, 10, 5]
    assert batches[0][1].dtype == np.float32
    batches = list(loaders.stream_batches(data, 10, limit=15))
    assert [len(b[1]) for b in batches] == [10, 5]


def test_groundtruth_manager_validation(tmp_path, rng):
    gt = rng.integers(0, 100, (5, 10)).astype(np.int32)
    p = str(tmp_path / "gt.ivecs")
    write_ivecs(p, gt)
    gtm = groundtruth.GroundtruthManager.load(p, base_size=100)
    np.testing.assert_array_equal(gtm.get(0, 5), gt[0, :5])
    with pytest.raises(ValueError, match="outside"):
        groundtruth.GroundtruthManager.load(p, base_size=50)


def test_gt_precompute_and_validate(rng):
    base = rng.normal(size=(500, 8)).astype(np.float32)
    queries = base[:10] + 0.001
    gtm = groundtruth.precompute(base, queries, k=5)
    assert (np.asarray([gtm.get(i, 1)[0] for i in range(10)])
            == np.arange(10)).all()
    vr = groundtruth.validate(base, queries, gtm, sample=10)
    assert vr.ok
    # corrupt GT -> validation fails
    bad = groundtruth.GroundtruthManager(
        np.roll(gtm.gt, 1, axis=0), base_size=500)
    vr2 = groundtruth.validate(base, queries, bad, sample=10)
    assert not vr2.ok


def test_gt_save_load_roundtrip(tmp_path, rng):
    base = rng.normal(size=(200, 8)).astype(np.float32)
    gtm = groundtruth.precompute(base, base[:5], k=10)
    p = str(tmp_path / "gt.ivecs")
    gtm.save_ivecs(p)
    gtm2 = groundtruth.GroundtruthManager.load(p, base_size=200)
    np.testing.assert_array_equal(gtm.gt, gtm2.gt)


def test_decoy_generator(rng):
    from fspann.query.decoy import DecoyGenerator
    gen = DecoyGenerator(dim=16, rate=0.5)
    real = rng.normal(size=(40, 16)).astype(np.float32) * 3
    mixed, src = gen.interleave(real)
    mask = src >= 0
    assert mask.sum() == 40
    assert len(mixed) >= 40
    # src maps each real mixed row back to its original query
    np.testing.assert_allclose(mixed[mask], real[src[mask]], rtol=1e-6)
    np.testing.assert_allclose(
        np.sort(np.linalg.norm(mixed[mask], axis=1)),
        np.sort(np.linalg.norm(real, axis=1)), rtol=1e-5)
    # decoys scaled to the real norm range
    if (~mask).any():
        scale = np.linalg.norm(real, axis=1).mean()
        norms = np.linalg.norm(mixed[~mask], axis=1)
        assert abs(norms.mean() - scale) / scale < 0.2
