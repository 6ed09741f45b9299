"""Stage B/C refine: exact L2 over decrypted candidates + top-K.

Reference behavior (query/QueryServiceImpl.java:238-322): for each candidate,
exact L2 distance to the query, sort ascending, return top-K.  Here the
decrypted candidate batch arrives as one dense ``[Q, R, d]`` tensor (the host
crypto layer decrypts in bulk) and the scan + top-k run on device.

Also provides the brute-force scorer used for ground-truth precompute
(reference api/GroundtruthPrecompute.java) — a chunked ``|x|^2 - 2 q·x``
matmul.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_F32_INF = jnp.float32(jnp.inf)


class RefineResult(NamedTuple):
    ids: jax.Array        # int32 [Q, K]  (-1 = pad)
    distances: jax.Array  # f32 [Q, K]    L2 (sqrt), inf = pad
    n_scored: jax.Array   # int32 [Q]


@partial(jax.jit, static_argnames=("k",))
def refine(qvecs: jax.Array, cand_vecs: jax.Array, cand_ids: jax.Array,
           valid: jax.Array, k: int) -> RefineResult:
    """Exact L2 + top-K over a decrypted candidate batch.

    Args:
      qvecs: f32 [Q, d] plaintext queries.
      cand_vecs: f32 [Q, R, d] decrypted candidate vectors (garbage where
        ``valid`` is False).
      cand_ids: int32 [Q, R].
      valid: bool [Q, R] — candidate present and decrypted successfully.
      k: top-K (static).
    """
    qv = qvecs.astype(jnp.float32)
    cv = cand_vecs.astype(jnp.float32)
    diff = cv - qv[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)                        # [Q, R]
    d2 = jnp.where(valid, d2, _F32_INF)
    neg, idx = jax.lax.top_k(-d2, k)                          # [Q, K]
    ok = jnp.take_along_axis(valid, idx, axis=-1)
    d2_sel = jnp.take_along_axis(d2, idx, axis=-1)
    # safe-where: never feed inf to sqrt (XLA sqrt(inf) misbehaves on some
    # backends and nan would poison the pad lanes).
    dist = jnp.where(ok, jnp.sqrt(jnp.where(ok, d2_sel, 0.0)), _F32_INF)
    ids = jnp.where(ok, jnp.take_along_axis(cand_ids, idx, axis=-1), -1)
    n_scored = jnp.sum(valid, axis=-1, dtype=jnp.int32)
    return RefineResult(ids, dist, n_scored)


@partial(jax.jit, static_argnames=("k",))
def _bruteforce_chunk(base: jax.Array, base_sq: jax.Array, qvecs: jax.Array,
                      k: int) -> tuple[jax.Array, jax.Array]:
    dots = jnp.einsum("qd,nd->qn", qvecs, base,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    d2 = base_sq[None, :] - 2.0 * dots                        # |x|^2 - 2 q·x
    neg, idx = jax.lax.top_k(-d2, k)
    return -neg, idx


def bruteforce_topk(base, qvecs, k: int, chunk: int = 262_144):
    """Exact top-K over the whole base, chunked over N to bound device memory.

    Returns (ids int32 [Q, K], distances f32 [Q, K]) with true L2 (sqrt).
    ``base`` may be a numpy array; chunks are shipped to device on demand.
    """
    import numpy as np

    q = jnp.asarray(qvecs, jnp.float32)
    qsq = jnp.sum(q * q, axis=-1)
    n = base.shape[0]
    best_d = None
    best_i = None
    for s in range(0, n, chunk):
        blk = jnp.asarray(base[s:s + chunk], jnp.float32)
        bsq = jnp.sum(blk * blk, axis=-1)
        kk = min(k, blk.shape[0])
        d2, idx = _bruteforce_chunk(blk, bsq, q, kk)
        idx = idx + s
        if best_d is None:
            best_d, best_i = d2, idx
        else:
            cat_d = jnp.concatenate([best_d, d2], axis=-1)
            cat_i = jnp.concatenate([best_i, idx], axis=-1)
            neg, sel = jax.lax.top_k(-cat_d, k)
            best_d = -neg
            best_i = jnp.take_along_axis(cat_i, sel, axis=-1)
    dist = jnp.sqrt(jnp.maximum(best_d + qsq[:, None], 0.0))
    return np.asarray(best_i, np.int32), np.asarray(dist, np.float32)
