"""Round-5 hardening regressions.

save_table host-twin: checkpoints must be written from host-resident
copies of the partition table / rerank codes — np.asarray on the
device-resident table is a full D2H copy per save.
"""

import dataclasses

import numpy as np
import pytest

from fspann.api.system import ForwardSecureANNSystem
from fspann.config import (SystemConfig, PaperConfig, RuntimeConfig,
                               EvalConfig)

DIM = 16
N = 1200


def _cfg(**runtime_kw):
    # encode_backend="cpu" is the only path with a host-built table to
    # twin; the device build keeps the save-time pull
    kw = dict(refinement_limit=400, max_global_candidates=400,
              block_size=32, encode_backend="cpu")
    kw.update(runtime_kw)
    return SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(**kw),
        eval=EvalConfig(k_variants=(1, 10)),
    ).validate()


@pytest.fixture
def corpus(rng):
    centers = rng.normal(size=(16, DIM)).astype(np.float32) * 5
    base = centers[rng.integers(0, 16, N)] + \
        rng.normal(size=(N, DIM)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 8)] + \
        rng.normal(size=(8, DIM)).astype(np.float32)
    return base, queries


@pytest.mark.parametrize("mode", ["scan", "probe"])
def test_save_table_host_twin_matches_device(tmp_path, corpus, mode):
    """The host twin written by save_table is bit-identical to the device
    table (and probe-mode rerank codes), in both finalize and load paths."""
    base, queries = corpus
    cfg = _cfg(routing_mode=mode,
               rerank_limit=200 if mode == "probe" else 0)
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / "t"), DIM)
    try:
        sys_.index_stream(base, batch_size=600)
        sys_.finalize_for_search()
        idx = sys_.index
        assert idx._table_host is not None
        for h, d in zip(idx._table_host, idx.table):
            np.testing.assert_array_equal(np.asarray(h), np.asarray(d))
        if mode == "probe":
            assert idx._codes_host is not None
            np.testing.assert_array_equal(
                idx._codes_host, np.asarray(idx.point_codes))

        # the persisted checkpoint round-trips through load_table with the
        # host twin re-established and identical to the device copy
        path = str(tmp_path / "t" / "table.npz")
        fresh = ForwardSecureANNSystem(cfg, str(tmp_path / "t"), DIM)
        try:
            assert fresh.index.load_table(path, expect_rows=N)
            assert fresh.index._table_host is not None
            for h, d in zip(fresh.index._table_host, fresh.index.table):
                np.testing.assert_array_equal(np.asarray(h), np.asarray(d))
            for h, d in zip(fresh.index._table_host, idx._table_host):
                np.testing.assert_array_equal(np.asarray(h), np.asarray(d))
            tok = fresh.create_token(queries[0], 5)
            assert len(fresh.search(tok)) == 5
        finally:
            fresh.shutdown()
    finally:
        sys_.shutdown()


def test_save_table_does_not_pull_device_table(tmp_path, corpus,
                                               monkeypatch):
    """save_table must not convert device arrays to host (the D2H pull).
    Poison the device table after finalize: if save_table reads it, the
    checkpoint diverges from the host twin; assert the saved npz matches
    the host twin exactly."""
    base, _ = corpus
    cfg = _cfg(routing_mode="scan")
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / "t"), DIM)
    try:
        sys_.index_stream(base, batch_size=600)
        sys_.finalize_for_search()
        idx = sys_.index
        import jax.numpy as jnp
        idx.table = idx.table._replace(
            ids=jnp.full_like(idx.table.ids, -7))
        idx.save_table(str(tmp_path / "t" / "table.npz"))
        z = np.load(str(tmp_path / "t" / "table.npz"))
        np.testing.assert_array_equal(z["ids"],
                                      np.asarray(idx._table_host.ids))
        assert not (z["ids"] == -7).all()
    finally:
        sys_.shutdown()
