"""SPMD axis descriptor shared by the trainer and the sharded runner.

The reference is single-address-space OpenMP (SURVEY.md §2.5: no MPI/NCCL
anywhere); scaling beyond one chip is new design, not translation.  The
mesh has two named axes:

* ``dp`` — batch rows (and their CSR edge spans) are split across devices;
  each device accumulates forces for its contiguous slice of the minibatch
  and a ``psum`` over ``dp`` merges the disjoint row updates;
* ``tp`` — the embedding dimension is sharded; per-edge force scalars
  (squared distances, dot products) are completed with a ``psum`` over
  ``tp`` injected through the force functions' ``rsum`` hook
  (models/forces.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SpmdAxes:
    """Names and sizes of the mesh axes a training step runs under.

    ``None`` axis names mean "not sharded along this axis"; the default
    instance is the single-device configuration.
    """

    dp: Optional[str] = None
    tp: Optional[str] = None
    n_dp: int = 1
    n_tp: int = 1

    @property
    def is_sharded(self) -> bool:
        return self.dp is not None or self.tp is not None

    def make_rsum(self):
        """Reduction over the (possibly tp-sharded) embedding dimension."""
        if self.tp is None:
            return lambda v: jnp.sum(v, axis=-1, keepdims=True)
        tp = self.tp

        def rsum(v):
            return jax.lax.psum(jnp.sum(v, axis=-1, keepdims=True), tp)

        return rsum

    def dp_rank(self):
        if self.dp is None:
            return 0
        return jax.lax.axis_index(self.dp)

    def psum_dp(self, v):
        return v if self.dp is None else jax.lax.psum(v, self.dp)
