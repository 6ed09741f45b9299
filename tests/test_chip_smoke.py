"""chip_smoke.py's phases at toy size on the CPU (n=4,096, d=32).

The phases are plain functions: here they run the same checks against the
same references as on the card, only smaller.  ``main()`` itself must refuse
to run without a GPU.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

N, D, Q = 4096, 32, 128


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = chip_smoke.serve_phase(str(tmp_path_factory.mktemp("smoke")),
                                 N, D, Q, insert_batch=1024,
                                 require_device_scan=False)
    yield out
    out["system"].shutdown()


def test_serve_phase_recall_and_rotation(served):
    m = served["metrics"]
    assert m["n"] == N and m["code_bits"] == 3072
    assert m["recall_at_10"] >= 0.99
    assert m["distance_ratio_at_100"] <= 1.01
    assert m["reencryption"]["new_version"] == 2
    assert m["reencryption"]["reencrypted"] > 0
    assert m["recall_at_10_after_rotation"] == m["recall_at_10"]


def test_scan_phase_matches_native(served):
    out = chip_smoke.scan_phase(served["system"].index, served["queries"],
                                n_batches=2)
    assert out["queries"] == 2 * chip_smoke.BATCH
    assert out["limit"] == chip_smoke.LIMIT


def test_encode_phase_bank_is_pinned(served):
    out = chip_smoke.encode_phase(served["base"], served["system"].index.bank,
                                  served["bank_sample"], rows=2048)
    assert out["bank_host_arrays"] and out["default_device_bank_equal"]
    # on the CPU both encode paths are the same arithmetic
    assert out["code_rows_differ_share"] == 0.0


def test_topl_phase_small(served):
    import jax.numpy as jnp
    from fspann.ops import hamming_scan

    idx = served["system"].index
    cb = idx.cfg.paper.code_bits
    state = hamming_scan.build_scan_state(idx._scan_codes, cb)
    qc, _ = idx.encode_queries(served["queries"][:64])
    qbits = jnp.asarray(hamming_scan.unpack_bits_numpy(np.asarray(qc), cb))
    out = chip_smoke.topl_phase(state, qbits, limit=100, repeats=2)
    assert out["shape"] == [64, N, 3072]
    assert set(out["times_ms"]) == {"scan_approx", "scan_exact", "int8_dot"}
    assert out["int8_dot_byte_bound_ms"] > 0


def test_compare_topl_detects_wrong_scores():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 2**32, size=(300, 4, 2), dtype=np.uint32)
    qc = rng.integers(0, 2**32, size=(3, 4, 2), dtype=np.uint32)
    from fspann.ops import native_scan

    ref = native_scan.scan_topl(codes, qc, None, 50)
    assert chip_smoke.compare_topl(ref.ids, ref.scores, ref.ids, ref.scores,
                                   codes, qc) == 0
    bad = np.array(ref.scores)
    bad[1, 10] += 1
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare_topl(ref.ids, bad, ref.ids, ref.scores, codes, qc)
    swapped = np.array(ref.ids)
    swapped[0, 0] = ref.ids[0, -1] if ref.ids[0, -1] != ref.ids[0, 0] \
        else ref.ids[0, 1]
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare_topl(swapped, ref.scores, ref.ids, ref.scores,
                                codes, qc)


def _toy_bank(r00=None):
    from fspann.ops import coding

    bank = coding.build_random_bank(d=16, m=16, lam=2, tables=2,
                                    divisions=2, seed=5)
    if r00 is None:
        return bank
    r = np.array(bank.r)
    r[0, 0] = r00
    return coding.GBank(bank.alpha, r, bank.omega, bank.m, bank.lam,
                        bank.tables, bank.divisions, bank.seed)


def test_host_codes_checked_accepts_equal_codes():
    from fspann.ops import coding

    x = np.random.default_rng(1).normal(size=(2000, 16)).astype(np.float32)
    bank = _toy_bank()
    dev, _ = coding.encode_numpy(x, bank)
    codes, differ = chip_smoke.host_codes_checked(x, bank, dev, "toy")
    assert differ == 0 and np.array_equal(codes, dev)


def test_host_codes_checked_rejects_misplaced_rows():
    from fspann.ops import coding

    x = np.random.default_rng(2).normal(size=(2000, 16)).astype(np.float32)
    bank = _toy_bank()
    dev, _ = coding.encode_numpy(x, bank)
    dev[[3, 4]] = dev[[4, 3]]          # two rows swapped between positions
    with pytest.raises(chip_smoke.SmokeFailure, match="bucket edge"):
        chip_smoke.host_codes_checked(x, bank, dev, "toy")
    dev[:500] = dev[500:1000]          # a whole block misplaced
    with pytest.raises(chip_smoke.SmokeFailure, match="rows differ"):
        chip_smoke.host_codes_checked(x, bank, dev, "toy")


def test_host_codes_checked_takes_bucket_edge_flips():
    from fspann.ops import coding

    x = np.random.default_rng(3).normal(size=(2000, 16)).astype(np.float32)
    y0 = float(np.dot(x[0].astype(np.float64),
                      np.asarray(_toy_bank().alpha[0, 0], np.float64)))
    # row 0's first projection lands 3e-6 above bucket 7 on the host and
    # 3e-6 below it on the "device"
    host = _toy_bank(np.float32(7.000003 - y0))
    dev_bank = _toy_bank(np.float32(6.999997 - y0))
    dev, _ = coding.encode_numpy(x, dev_bank)
    codes, differ = chip_smoke.host_codes_checked(x, host, dev, "toy")
    assert differ >= 1
    assert np.array_equal(codes, dev)
    assert not np.array_equal(coding.encode_numpy(x[:1], host)[0], dev[:1])


def test_bucket_indices_inverts_packing():
    from fspann.ops import coding

    bank = _toy_bank()
    x = np.random.default_rng(4).normal(size=(64, 16)).astype(np.float32)
    codes, _ = coding.encode_numpy(x, bank)
    h = np.asarray(coding.project_h(x, bank)).astype(np.int64)
    assert np.array_equal(chip_smoke._bucket_indices(codes, bank.m, bank.lam),
                          h % (1 << bank.lam))


def test_lowering_summary_reads_library_calls():
    hlo = ('%c = (s32[64,8]) custom-call(%a), '
           'custom_call_target="__cub$DeviceRadixSort"\n'
           '%f = s32[2] fusion(%x), kind=kCustom, backend_config={'
           '"fusion_backend_config":{"kind":"__triton_nested_gemm_fusion"}}\n'
           '%s = s32[4] sort(%y), dimensions={0}\n')
    out = chip_smoke.lowering_summary(hlo)
    assert out["custom_calls"] == ["__cub$DeviceRadixSort"]
    assert out["fusion_backends"] == ["__triton_nested_gemm_fusion"]
    assert out["sorts"] == 1


def test_mesh_phase_four_virtual_devices(tmp_path):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs four devices (the CPU suite has eight virtual)")
    out = chip_smoke.mesh_phase(str(tmp_path / "mesh"), N, D, Q, 4,
                                insert_batch=1024)
    assert out["shard_rows"] == N // 4
    assert len(set(out["placement"]["bits"])) == 4
    assert out["recall_at_10"] >= 0.99


def test_main_without_gpu_fails():
    import jax

    if jax.devices()[0].platform == "gpu":
        pytest.skip("on a GPU main() runs the full-size check")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = chip_smoke.main([])
    assert rc != 0
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert last["ok"] is False


# -- on the card: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/ ------

@pytest.mark.gpu
def test_gpu_scan_matches_native(gpu_device):
    import jax
    import jax.numpy as jnp
    from fspann.ops import hamming_scan, native_scan

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 2**32, size=(20_000, 24, 4), dtype=np.uint32)
    qc = rng.integers(0, 2**32, size=(64, 24, 4), dtype=np.uint32)
    with jax.default_device(gpu_device):
        state = hamming_scan.build_scan_state(codes, 128)
        qbits = jnp.asarray(hamming_scan.unpack_bits_numpy(qc, 128))
        res = hamming_scan.scan(state, qbits, jnp.zeros(len(codes), bool),
                                500)
    ref = native_scan.scan_topl(codes, qc, None, 500)
    chip_smoke.compare_topl(res.ids, res.scores, ref.ids, ref.scores,
                            codes, qc)


@pytest.mark.gpu
def test_gpu_encode_matches_numpy(gpu_device):
    import jax
    import jax.numpy as jnp
    from fspann.ops import coding

    rng = np.random.default_rng(4)
    x = rng.normal(size=(8192, 64)).astype(np.float32)
    bank = coding.build_bank_from_sample(x[:1000], m=64, lam=2, tables=8,
                                         divisions=3, seed=13)
    assert isinstance(bank.alpha, np.ndarray)
    with jax.default_device(gpu_device):
        codes, _ = coding.encode(jnp.asarray(x), bank)
    codes_np, _ = coding.encode_numpy(x, bank)
    differ = np.any(np.asarray(codes) != codes_np, axis=(1, 2)).mean()
    # only bucket-boundary flips may differ (f32 summation order)
    assert differ < 1e-3
