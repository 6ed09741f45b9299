"""fspann — forward-secure encrypted ANN search on an accelerator.

A from-scratch JAX/XLA rebuild of the capabilities of the Java reference
system FSPANN (Mehran-Memon/fspann-query-system).  The geometric routing core
(LSH coding, greedy partition construction, multi-probe candidate generation,
the Hamming scan, L2 refine + top-k) runs as batched device computations over
dense ``[G, N]`` arrays in device memory; AES-256-GCM ciphertexts, the
HMAC-derived versioned keystore, selective re-encryption and the metadata
store stay host-side (C AES-NI kernels + an embedded append-only store).

Core invariant preserved from the reference (README.md:79-99 of the
reference): **routing–ciphertext orthogonality** — routing state is a pure
function of (seed, config, sample statistics) and never depends on key or
cipher state, so key rotation/re-encryption never rebuilds the device index.
"""

import jax

# LSH banks are built on the host CPU backend so that they are bit-identical
# on every platform (ops/coding._cpu_device).  An explicit platform list
# such as JAX_PLATFORMS=cuda would leave that backend unresolvable, so a
# trailing "cpu" is appended; the first entry stays the default backend.
_platforms = jax.config.jax_platforms or ""
if _platforms and "cpu" not in _platforms.split(","):
    jax.config.update("jax_platforms", _platforms + ",cpu")

# Routing keys are 63-bit sortable integers (reference:
# index/paper/GreedyPartitioner.java:87-96), carried as int64; all floating
# point arrays in this package are explicitly float32/bfloat16 so enabling
# x64 never widens compute dtypes.
jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
