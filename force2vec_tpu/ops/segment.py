"""Segment reduction of per-edge forces into batch rows.

The reference accumulates each edge's force into its source row of a
batch-local buffer (``prevCoordinates[bindex-baseindex+d] += …``,
sample/algorithms.cpp:603-612).  Two equivalent forms:

* ``scatter`` (the default): ``jax.ops.segment_sum``, a scatter-add;
* ``matmul``: a one-hot matmul ``acc += onehot(src_local)ᵀ · F`` at
  ``Precision.HIGHEST`` (so no TF32 rounding enters).

On an H100 at the CLI's default batch schedule the scatter form is the
faster one (PERF.md); the matmul form stays as the cross-check.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_sum_into_batch(
    forces: jnp.ndarray,  # [E, D] per-edge force contributions (already masked)
    src_local: jnp.ndarray,  # [E] int32 in [0, B)
    valid: jnp.ndarray,  # [E] bool
    batch_size: int,
    mode: str = "scatter",
) -> jnp.ndarray:
    """Sum per-edge forces into their source rows → [B, D]."""
    if mode == "matmul":
        # Zero invalid lanes *before* the matmul: padded sentinel edges can
        # carry NaN forces (e.g. dist 0 → 0·inf) and 0·NaN is NaN.
        f = jnp.where(valid[:, None], forces, 0)
        onehot = (
            src_local[None, :] == jnp.arange(batch_size, dtype=src_local.dtype)[:, None]
        ) & valid[None, :]
        return jax.lax.dot(
            onehot.astype(forces.dtype),
            f,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        ).astype(forces.dtype)
    if mode == "scatter":
        f = jnp.where(valid[:, None], forces, 0)
        return jax.ops.segment_sum(f, src_local, num_segments=batch_size)
    raise ValueError(f"unknown segment mode {mode!r}")
