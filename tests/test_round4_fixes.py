"""Round-4 additions: 24-bit candidate-transfer packing."""

import numpy as np
import jax.numpy as jnp

from fspann.query.service import _pack24, _unpack24, _PACK24_MAX


def test_pack24_roundtrip_edges():
    ids = np.array([[-1, 0, 1, 255, 256, 65535, 65536, _PACK24_MAX]],
                   np.int32)
    packed = np.asarray(_pack24(jnp.asarray(ids)))
    assert packed.shape == (1, 8, 3) and packed.dtype == np.uint8
    np.testing.assert_array_equal(_unpack24(packed), ids)


def test_pack24_random_roundtrip():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, _PACK24_MAX + 1, size=(7, 513)).astype(np.int32)
    np.testing.assert_array_equal(
        _unpack24(np.asarray(_pack24(jnp.asarray(ids)))), ids)


def test_packed_transfer_results_identical(tmp_path, rng, monkeypatch):
    """Force the packed transfer on the CPU suite and check search results
    are bit-identical to the unpacked path."""
    import dataclasses

    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import SystemConfig

    base = rng.normal(size=(3000, 16)).astype(np.float32)
    queries = base[:8] + 0.01 * rng.normal(size=(8, 16)).astype(np.float32)

    def run(flag, sub):
        monkeypatch.setenv("FSPANN_PACK24", flag)
        cfg = SystemConfig()
        cfg = dataclasses.replace(
            cfg, runtime=dataclasses.replace(
                cfg.runtime, routing_mode="scan", rerank_limit=200,
                refinement_limit=512, max_global_candidates=512,
                scan_native="off", adaptive_decrypt_margin=40))
        sys_ = ForwardSecureANNSystem(cfg, str(tmp_path / sub), 16)
        sys_.index_stream(base, batch_size=1000)
        sys_.finalize_for_search()
        res = sys_.query_service.search_batch(
            [sys_.create_token(q, 10) for q in queries])
        sys_.shutdown()
        return res

    on = run("1", "on")
    off = run("0", "off")
    np.testing.assert_array_equal(on.ids, off.ids)
    np.testing.assert_array_equal(on.distances, off.distances)
    assert (on.ids >= 0).all()


def test_short_open_path_boundaries(tmp_path, rng):
    """The aggregated short-record GCM open covers records up to 128 GHASH
    blocks and must agree with the generic path bit-for-bit; dims around
    the table boundary (f32 dim 500 = exactly 128 blocks, dim 600 falls
    back) and odd partial-block bodies (i8) all roundtrip."""
    from fspann.crypto.keys import KeyManager
    from fspann.store.point_store import PointStore

    km = KeyManager(str(tmp_path / "ks"))
    for dim, dtype in ((1, "f32"), (3, "i8"), (31, "f16"), (128, "f32"),
                       (500, "f32"), (600, "f32")):
        vecs = rng.normal(size=(17, dim)).astype(np.float32)
        s = PointStore(str(tmp_path / f"db_{dim}_{dtype}"), km, dim=dim,
                       dtype=dtype)
        s.insert_batch(np.arange(17), vecs)
        out, ok = s.load_decrypt_batch(np.arange(17))
        assert ok.all()
        np.testing.assert_allclose(out, s.quantize(vecs), rtol=1e-3,
                                   atol=1e-3)
        s.close()
