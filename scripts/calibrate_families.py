"""Calibrate the glove-like / redcaps-like / gist-like instances against the
reference's measured recall bands (BASELINE.md):

  glove-100  recall@100 band 0.14–0.27 across its 5 profiles
  redcaps512 recall@100 band 0.04–0.10 across its 6 profiles
  gist-960   (no reference row; target is OUR scan-mode recall@10 >= 0.85)

Runs the reference-shaped probe profiles from configs/<family>.json on a
100k–200k instance (CPU — recall is platform-independent) and prints the
recall ladder.  Iterate generator knobs until the band and the probes
response match, then scale to 1M.

Usage:
  JAX_PLATFORMS=cpu python scripts/calibrate_families.py glove [N] [knobs...]
  JAX_PLATFORMS=cpu python scripts/calibrate_families.py redcaps [N]
  JAX_PLATFORMS=cpu python scripts/calibrate_families.py gist [N]
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np



def relative_contrast(base, queries, k=10):
    rng = np.random.default_rng(0)
    sub = base[rng.choice(len(base), min(len(base), 100_000), replace=False)]
    rc = []
    for q in queries[:32]:
        d2 = ((sub - q) ** 2).sum(axis=1)
        d2.sort()
        rc.append(np.sqrt(d2[k - 1]) / np.sqrt(d2.mean()))
    return float(np.mean(rc))


def run_profile(base, queries, gtm, cfg_path, profile, overrides=None):
    import dataclasses

    from fspann.api.system import ForwardSecureANNSystem
    from fspann.config import load_config

    d = base.shape[1]
    cfg = load_config(cfg_path, profile, overrides)
    cfg = dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, encode_backend="cpu"))
    work = tempfile.mkdtemp(prefix="fspann_fam_")
    try:
        sys_ = ForwardSecureANNSystem(cfg, os.path.join(work, "db"), d,
                                      query_batch=64)
        t0 = time.time()
        sys_.index_stream(base, batch_size=100_000)
        sys_.finalize_for_search()
        build_s = time.time() - t0
        t0 = time.time()
        agg = sys_.run_queries(queries, gtm, base, ks=(10, 100))
        wall = time.time() - t0
        cols = sys_.profiler.columns()
        sel = cols["k"] == 10
        scan = float(np.mean(cols["cand_refined"][sel])) / len(base)
        print(f"  {profile:<22s} r@10={agg.recall_at_k[10]:.4f} "
              f"r@100={agg.recall_at_k[100]:.4f} "
              f"ratio={agg.ratio_at_k[100]:.4f} "
              f"ART={agg.mean_art_ms:.1f}ms q/s={len(queries)/wall:.1f} "
              f"scan={scan:.3%} build={build_s:.0f}s", flush=True)
        sys_.shutdown()
        return agg
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main():
    fam = sys.argv[1] if len(sys.argv) > 1 else "glove"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    nq = 200
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    from fspann.io import groundtruth, synthetic

    t0 = time.time()
    if fam == "glove":
        spectrum = float(sys.argv[3]) if len(sys.argv) > 3 else 1.25
        norm_sigma = float(sys.argv[4]) if len(sys.argv) > 4 else 0.55
        base, queries = synthetic.glove_like_corpus(
            n, 100, nq, spectrum=spectrum, norm_sigma=norm_sigma)
        cfg_path = os.path.join(root, "configs", "glove100.json")
        print(f"glove_like n={n} spectrum={spectrum} "
              f"norm_sigma={norm_sigma}")
    elif fam == "redcaps":
        d_eff = int(sys.argv[3]) if len(sys.argv) > 3 else 512
        spectrum = float(sys.argv[4]) if len(sys.argv) > 4 else 0.0
        cone = float(sys.argv[5]) if len(sys.argv) > 5 else 2.0
        base, queries = synthetic.redcaps_like_corpus(
            n, 512, nq, d_eff=d_eff, spectrum=spectrum, cone=cone)
        cfg_path = os.path.join(root, "configs", "redcaps.json")
        print(f"redcaps_like n={n} d_eff={d_eff} spectrum={spectrum} "
              f"cone={cone}")
    elif fam == "gist":
        base, queries = synthetic.lsh_hard_corpus(n, 960, nq)
        cfg_path = os.path.join(root, "configs", "gist1m.json")
        print(f"gist-like (lsh_hard 960d) n={n}")
    else:
        raise SystemExit(f"unknown family {fam}")
    print(f"corpus {time.time()-t0:.0f}s  "
          f"rel_contrast@10={relative_contrast(base, queries):.3f}",
          flush=True)

    gtm = groundtruth.precompute(base, queries, k=100)
    profiles = sorted(json.load(open(cfg_path)).get("profiles", {}))
    only = os.environ.get("CAL_PROFILES")
    if only:
        profiles = [p for p in profiles if p in only.split(",")]
    for p in profiles:
        run_profile(base, queries, gtm, cfg_path, p)


if __name__ == "__main__":
    main()
