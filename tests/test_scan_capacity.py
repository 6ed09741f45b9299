"""Capacity-padded scan state (runtime.scan_capacity_rows): live inserts
fill tombstoned padding in place — constant device-array shape, no XLA
recompile per insert event.  Single-chip counterpart of the mesh path's
``build(capacity=)`` (parallel/sharded.py); reference has no live insert
at all (index frozen at finalizeForSearch, PartitionedIndexService.java).
"""

import dataclasses

import numpy as np
import pytest

from fspann.api.system import ForwardSecureANNSystem
from fspann.config import (EvalConfig, PaperConfig, RuntimeConfig,
                               SystemConfig)


def _cfg(capacity, packed="off"):
    return SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=3, seed=13),
        runtime=RuntimeConfig(refinement_limit=400,
                              max_global_candidates=400,
                              block_size=32, routing_mode="scan",
                              rerank_limit=100, scan_packed=packed,
                              scan_native="off",
                              scan_capacity_rows=capacity),
        eval=EvalConfig(k_variants=(1, 10)),
    ).validate()


def _build(tmp_path, rng, cfg, tag, n=900, dim=16, base=None):
    if base is None:
        base = rng.normal(size=(n, dim)).astype(np.float32) * 3
    sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / tag), dim,
                                  query_batch=4)
    sys_.index_stream(base, batch_size=300)
    sys_.finalize_for_search()
    return sys_, base


@pytest.mark.parametrize("packed", ["off", "on"])
def test_capacity_padding_matches_exact_fit(tmp_path, rng, packed):
    """Search results with a capacity-padded state are identical to the
    exact-fit state (padding is invisible to ranking)."""
    n, dim = 900, 16
    s_pad, base = _build(tmp_path, rng, _cfg(n + 256, packed), f"p{packed}",
                         n, dim)
    s_fit, _ = _build(tmp_path, rng, _cfg(0, packed), f"f{packed}", n, dim,
                      base=base)
    try:
        st = s_pad.index._scan_state
        rows = st.words.shape[0] if hasattr(st, "words") else \
            st.bits.shape[0]
        assert rows == n + 256
        assert s_pad.index._scan_rows == n + 256
        for q in base[:6]:
            a = [(r.id, round(r.distance, 5))
                 for r in s_pad.search(s_pad.create_token(q, 10))]
            b = [(r.id, round(r.distance, 5))
                 for r in s_fit.search(s_fit.create_token(q, 10))]
            assert a == b
    finally:
        s_pad.shutdown()
        s_fit.shutdown()


@pytest.mark.parametrize("packed", ["off", "on"])
def test_live_insert_fills_padding_in_place(tmp_path, rng, packed):
    """Inserts within capacity keep the device-array shape constant; the
    new rows are immediately searchable and deletable."""
    n, dim = 900, 16
    sys_, base = _build(tmp_path, rng, _cfg(n + 64, packed), f"ip{packed}",
                        n, dim)
    try:
        st0 = sys_.index._scan_state
        shape0 = (st0.words if hasattr(st0, "words") else st0.bits).shape
        new_vecs = rng.normal(size=(8, dim)).astype(np.float32) * 3 + 40.0
        new_ids = np.arange(n, n + 8)
        sys_.insert_live(new_ids, new_vecs)
        st1 = sys_.index._scan_state
        assert (st1.words if hasattr(st1, "words")
                else st1.bits).shape == shape0
        assert sys_.index._n_rows == n + 8
        for i in range(8):
            res = sys_.search(sys_.create_token(new_vecs[i], 3))
            assert res[0].id == n + i
        # old rows unaffected, deletes on appended rows work
        assert sys_.search(sys_.create_token(base[7], 1))[0].id == 7
        sys_.delete(new_ids[:4])
        res = sys_.search(sys_.create_token(new_vecs[0], 3))
        assert res[0].id != n
    finally:
        sys_.shutdown()


def test_overflow_grows_geometrically(tmp_path, rng):
    """Inserting past capacity reallocates once with headroom; results stay
    correct and subsequent inserts fill the new padding in place."""
    n, dim = 900, 16
    sys_, base = _build(tmp_path, rng, _cfg(n + 8), "ovf", n, dim)
    try:
        v = rng.normal(size=(24, dim)).astype(np.float32) * 3 + 40.0
        ids = np.arange(n, n + 24)
        sys_.insert_live(ids[:8], v[:8])        # fills the padding exactly
        sys_.insert_live(ids[8:16], v[8:16])    # overflow -> grow
        grown = sys_.index._scan_rows
        assert grown >= n + 16 + 4096           # geometric headroom
        st = sys_.index._scan_state
        assert (st.words if hasattr(st, "words")
                else st.bits).shape[0] == grown
        sys_.insert_live(ids[16:], v[16:])      # fits the new padding
        assert sys_.index._scan_rows == grown
        for i in range(24):
            res = sys_.search(sys_.create_token(v[i], 1))
            assert res[0].id == n + i
        assert sys_.search(sys_.create_token(base[3], 1))[0].id == 3
    finally:
        sys_.shutdown()


def test_exact_fit_keeps_exact_growth(tmp_path, rng):
    """scan_capacity_rows=0 (the default) preserves the pre-capacity
    behavior: appends grow the state to the exact new size."""
    n, dim = 900, 16
    sys_, base = _build(tmp_path, rng, _cfg(0), "exact", n, dim)
    try:
        v = rng.normal(size=(5, dim)).astype(np.float32) * 3 + 40.0
        sys_.insert_live(np.arange(n, n + 5), v)
        assert sys_.index._scan_rows == n + 5
        st = sys_.index._scan_state
        assert (st.words if hasattr(st, "words")
                else st.bits).shape[0] == n + 5
        for i in range(5):
            assert sys_.search(
                sys_.create_token(v[i], 1))[0].id == n + i
    finally:
        sys_.shutdown()


def test_capacity_restore_roundtrip(tmp_path, rng):
    """Fast restore of a capacity-padded build reproduces search results
    bit-exactly (checkpoint holds real rows only; padding re-applied)."""
    cfg = _cfg(1200)
    n, dim = 900, 16
    sys_, base = _build(tmp_path, rng, cfg, "rt", n, dim)
    v = rng.normal(size=(4, dim)).astype(np.float32) * 3 + 40.0
    sys_.insert_live(np.arange(n, n + 4), v)
    sys_.flush_all()
    before = [(r.id, round(r.distance, 5))
              for r in sys_.search(sys_.create_token(v[0], 10))]
    sys_.shutdown()

    sys2 = ForwardSecureANNSystem(cfg, str(tmp_path / "rt"), dim,
                                  query_batch=4)
    try:
        assert sys2.restore_index_from_disk()
        assert sys2.index._scan_rows == 1200
        after = [(r.id, round(r.distance, 5))
                 for r in sys2.search(sys2.create_token(v[0], 10))]
        assert before == after
    finally:
        sys2.shutdown()
