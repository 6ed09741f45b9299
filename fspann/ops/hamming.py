"""Packed-code Hamming distance (XOR + popcount on uint32 words).

Replaces the reference's ``GreedyPartitioner.hamming`` BitSet clone+xor+
cardinality (GreedyPartitioner.java:78-82) with vectorized
``lax.population_count``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def hamming(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamming distance between packed codes; last axis is the word axis.

    Broadcasts like jnp: ``a [..., W]``, ``b [..., W]`` → int32 ``[...]``.
    """
    x = jnp.bitwise_xor(a, b)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
