"""Break down the host decrypt stage (Stage B) phase by phase.

Replicates PointStore.load_decrypt_batch's pipeline on a real store and
times each phase: metadata lookup, offset argsort, AAD build, native GCM
open.  Also reports the cross-query duplicate factor of a routed candidate
batch (dedup potential).

Usage: JAX_PLATFORMS=cpu python scripts/profile_decrypt.py [N] [CANDS]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 300_000
    cands = int(sys.argv[2]) if len(sys.argv) > 2 else 358_000
    d = 128

    import tempfile
    import shutil
    from fspann.crypto.keys import KeyManager
    from fspann.store.point_store import PointStore, TAG_LEN
    from fspann.crypto import aesgcm
    from fspann.types import aad_batch

    work = tempfile.mkdtemp(prefix="fspann_prof_")
    try:
        km = KeyManager(os.path.join(work, "ks.blob"))
        store = PointStore(os.path.join(work, "db"), km, dim=d)
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        for s in range(0, n, 100_000):
            e = min(s + 100_000, n)
            store.insert_batch(np.arange(s, e),
                               rng.normal(size=(e - s, d)).astype(np.float32))
        print(f"build {n}: {time.perf_counter()-t0:.1f}s", flush=True)

        # candidate set shaped like a routed batch: clustered-ish ids with
        # cross-query duplicates (each "query" probes a contiguous zone)
        q, r = 64, cands // 64
        zones = rng.integers(0, n - 8 * r, q)
        ids = (zones[:, None] + rng.integers(0, 8 * r, (q, r))).reshape(-1)
        dup = len(ids) / max(len(np.unique(ids)), 1)
        print(f"candidates: {len(ids)}  duplicate factor {dup:.2f}")

        # phase timings (mirrors load_decrypt_batch)
        meta = store.meta
        for rep in range(2):
            t = {}
            t0 = time.perf_counter()
            kv_all, off_all = meta.lookup_batch(ids)
            t["lookup"] = time.perf_counter() - t0

            present = kv_all > 0
            versions = np.unique(kv_all[present])
            body = 4 * d
            vecs = np.zeros((len(ids), d), np.float32)
            staging = vecs.reshape(-1).view(np.uint8)

            t0 = time.perf_counter()
            sel = np.flatnonzero(kv_all == versions[0])
            sel = sel[np.argsort(off_all[sel], kind="stable")]
            t["argsort"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            aads = aad_batch(ids[sel], int(versions[0]), d)
            t["aad"] = time.perf_counter() - t0

            reader = store._reader(int(versions[0]))
            t0 = time.perf_counter()
            ok = aesgcm.open_batch_records(
                [km.gcm_for(int(versions[0]))],
                np.zeros(len(sel), np.uint32),
                reader._buf, off_all[sel].astype(np.uint64),
                20, 32, 32 + body, body,
                aads, staging, (sel * body).astype(np.uint64))
            t["gcm_open"] = time.perf_counter() - t0
            assert ok.all()

            t0 = time.perf_counter()
            ok2 = aesgcm.open_batch_records_by_id(
                km.gcm_for(int(versions[0])),
                reader._buf, off_all[sel].astype(np.uint64),
                20, 32, 32 + body, body,
                ids[sel], int(versions[0]), d,
                staging, (sel * body).astype(np.uint64))
            t["gcm_open_fused_aad"] = time.perf_counter() - t0
            assert ok2.all()

            # whole-call comparison + dedup variant
            t0 = time.perf_counter()
            store.load_decrypt_batch(ids)
            t["full_call"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            uniq, inv = np.unique(ids, return_inverse=True)
            vu, oku = store.load_decrypt_batch(uniq)
            _ = vu[inv]
            t["dedup_call+scatter"] = time.perf_counter() - t0

            if rep:
                total_mb = len(sel) * (body + TAG_LEN + 32 + 4) / 1e6
                print(f"bytes touched: {total_mb:.0f} MB ct+hdr, "
                      f"{len(ids)*body/1e6:.0f} MB plaintext out")
                for k, v in t.items():
                    print(f"  {k:20s} {v*1e3:8.1f} ms "
                          f"({v*1e3/64:.2f} ms/query-of-64)")
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
