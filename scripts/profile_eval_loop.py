"""Profile the host-side serving+eval loop (everything EXCEPT the device
route, which the pipelined device path hides): where do the non-stage
milliseconds per query go?

Runs a small-code CPU corpus (cheap route) at the parity decrypt shape
(L=2000, batch 64, adaptive margin) and cProfiles run_queries.  Usage:

    JAX_PLATFORMS=cpu python scripts/profile_eval_loop.py [N] [Q]
"""

import cProfile
import os
import pstats
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from fspann.config import SystemConfig, PaperConfig, RuntimeConfig
from fspann.api.system import ForwardSecureANNSystem
from fspann.io import groundtruth, synthetic


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    q = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    d = 128
    base, queries = synthetic.lsh_hard_corpus(n, d, q, seed=42)
    cfg = SystemConfig(
        paper=PaperConfig(m=8, lam=2, divisions=2, tables=2, seed=13),
        runtime=RuntimeConfig(refinement_limit=56000,
                              max_global_candidates=56000,
                              rerank_limit=2000,
                              routing_mode="scan",
                              adaptive_decrypt_margin=40,
                              encode_backend="cpu")).validate()
    gtm = groundtruth.precompute(base, queries, k=100)
    with tempfile.TemporaryDirectory() as td:
        sys_ = ForwardSecureANNSystem(cfg, os.path.join(td, "db"), d,
                                      query_batch=64)
        try:
            sys_.index_stream(base, batch_size=100_000)
            sys_.finalize_for_search()
            sys_.run_queries(queries[:64], gtm, base, ks=(10,))  # warm
            sys_.profiler.clear_rows()
            prof = cProfile.Profile()
            prof.enable()
            agg = sys_.run_queries(queries, gtm, base, ks=(1, 10, 100))
            prof.disable()
            print(f"ART {agg.mean_art_ms:.2f} ms  recall@10 "
                  f"{agg.recall_at_k.get(10, float('nan')):.4f}")
            st = pstats.Stats(prof)
            st.sort_stats("cumulative").print_stats(30)
        finally:
            sys_.shutdown()


if __name__ == "__main__":
    main()
