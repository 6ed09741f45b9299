"""Multi-dimension system test (reference DimensionState behavior)."""

import numpy as np

from fspann.api.multidim import MultiDimSystem
from fspann.config import (EvalConfig, PaperConfig, RuntimeConfig,
                               SystemConfig)


def small_cfg():
    return SystemConfig(
        paper=PaperConfig(m=6, lam=2, divisions=2, tables=2, seed=5),
        runtime=RuntimeConfig(refinement_limit=300, max_global_candidates=300,
                              block_size=32),
        eval=EvalConfig(k_variants=(1, 5)),
    ).validate()


def test_two_dims_share_keys(tmp_path, rng):
    md = MultiDimSystem(small_cfg(), str(tmp_path / "db"))
    try:
        v8 = rng.normal(size=(1100, 8)).astype(np.float32)
        v16 = rng.normal(size=(1100, 16)).astype(np.float32)
        md.batch_insert(np.arange(1100), v8)
        md.batch_insert(np.arange(1100), v16)
        md.finalize_for_search()
        assert md.dims == [8, 16]

        t8 = md.create_token(v8[3], 1)
        t16 = md.create_token(v16[5], 1)
        assert md.search(t8)[0].id == 3
        assert md.search(t16)[0].id == 5
        # one shared keystore
        assert md.system_for(8).km is md.system_for(16).km

        rep = md.run_selective_reencryption()
        assert rep["new_version"] == 2
        assert set(rep["per_dim"]) == {8, 16}
        assert rep["per_dim"][8]["reencrypted"] > 0
        # both dims still query correctly post-rotation
        assert md.search(md.create_token(v8[3], 1))[0].id == 3
        assert md.search(md.create_token(v16[5], 1))[0].id == 5
    finally:
        md.shutdown()


def test_multidim_restore_all(tmp_path, rng):
    md = MultiDimSystem(small_cfg(), str(tmp_path / "db"))
    v8 = rng.normal(size=(1100, 8)).astype(np.float32)
    v16 = rng.normal(size=(1100, 16)).astype(np.float32)
    md.batch_insert(np.arange(1100), v8)
    md.batch_insert(np.arange(1100), v16)
    md.finalize_for_search()
    t8 = md.create_token(v8[3], 1)
    r1 = md.search(t8)[0].id
    md.shutdown()

    md2 = MultiDimSystem(small_cfg(), str(tmp_path / "db"))
    try:
        restored = md2.restore_all()
        assert restored == {8: 1100, 16: 1100}
        assert md2.search(md2.create_token(v8[3], 1))[0].id == r1
        assert md2.search(md2.create_token(v16[5], 1))[0].id == 5
    finally:
        md2.shutdown()


def test_multidim_background_reencryption_shares_keystore(tmp_path, rng):
    """Constructor-injected KeyManager: a sub-system's background daemon
    must migrate against the SHARED keystore (the round-1 attribute swap
    left daemons holding a throwaway one)."""
    import dataclasses
    from fspann.config import ReencryptionConfig
    cfg = dataclasses.replace(
        small_cfg(),
        reencryption=ReencryptionConfig(background_enabled=True,
                                        background_interval_s=30.0))
    md = MultiDimSystem(cfg, str(tmp_path / "db"))
    try:
        v8 = rng.normal(size=(1100, 8)).astype(np.float32)
        md.batch_insert(np.arange(1100), v8)
        md.finalize_for_search()
        sub = md.system_for(8)
        assert sub.background is not None
        # the whole chain sees one keystore
        assert sub.background.svc.km is md.km
        assert sub.store.km is md.km and sub.tokens.km is md.km
        md.km.rotate()
        migrated = sub.background.run_once()
        assert migrated > 0
        assert sub.store.meta.count_with_version(2) == migrated
    finally:
        md.shutdown()


def test_multidim_scan_mode(tmp_path, rng):
    """MultiDimSystem serves scan-mode sub-systems off one shared keystore."""
    import dataclasses

    from fspann.api.multidim import MultiDimSystem
    from fspann.config import (SystemConfig, PaperConfig, RuntimeConfig,
                                   EvalConfig)

    cfg = SystemConfig(
        paper=PaperConfig(m=6, lam=2, divisions=2, tables=2, seed=5),
        runtime=RuntimeConfig(refinement_limit=300, max_global_candidates=300,
                              block_size=32, routing_mode="scan",
                              rerank_limit=80),
        eval=EvalConfig(k_variants=(1, 5))).validate()
    md = MultiDimSystem(cfg, str(tmp_path / "md"))
    try:
        for dim in (8, 24):
            base = rng.normal(size=(1100, dim)).astype(np.float32) * 3
            s = md.system_for(dim)
            s.index_stream(base, batch_size=400)
            s.finalize_for_search()
            tok = s.create_token(base[5], 5)
            assert s.search(tok)[0].id == 5
        # one keystore across dims
        assert md.system_for(8).km is md.system_for(24).km
    finally:
        md.shutdown()
