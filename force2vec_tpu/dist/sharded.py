"""Multi-device training: shard_map over a (dp, tp) mesh.

The reference has no distributed backend at all (SURVEY.md §2.5 — pure
OpenMP shared memory); this module is the from-scratch answer.  The
embedding table is laid out ``P(None, "tp")``: rows replicated across the
``dp`` axis, the embedding dimension sharded across ``tp``.  Each training
step then needs exactly two collectives:

* a ``psum`` over ``tp`` completing per-edge scalars (inside the force
  functions via the ``rsum`` hook, models/forces.py), and
* one ``psum`` over ``dp`` merging the disjoint per-rank slices of the
  batch update buffer (train/trainer.py batch_body).

Row updates are disjoint by construction (each dp rank owns a contiguous
slice of the minibatch and its contiguous CSR edge span), so the dp-psum is
exact, not approximate — the semantics are bit-for-bit those of the
single-device step, which the multi-device parity test asserts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from force2vec_tpu.dist.spmd import SpmdAxes
from force2vec_tpu.train.trainer import Force2Vec


def make_mesh(
    devices: Optional[Sequence] = None,
    dp: Optional[int] = None,
    tp: int = 1,
) -> Mesh:
    """Build a (dp, tp) mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    if dp is None:
        dp = len(devices) // tp
    assert dp * tp == len(devices), f"{dp}x{tp} != {len(devices)} devices"
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))


def replicate(garr: dict, mesh: Mesh) -> dict:
    """Copy the graph arrays to every device of ``mesh`` once, so that each
    training call finds them in place instead of re-sending them."""
    rep = NamedSharding(mesh, P())
    return {k: jax.device_put(np.asarray(v), rep) for k, v in garr.items()}


class ShardedForce2Vec:
    """Run a :class:`Force2Vec` training step over a device mesh.

    Wraps the trainer's SPMD-parameterized iteration in ``shard_map``; the
    embedding is placed ``P(None, "tp")`` and donated across steps.
    """

    def __init__(self, fv: Force2Vec, mesh: Mesh):
        self.fv = fv
        self.mesh = mesh
        n_dp = mesh.shape["dp"]
        n_tp = mesh.shape["tp"]
        if fv.dg.batch_size % n_dp:
            raise ValueError(
                f"batch size {fv.dg.batch_size} not divisible by dp={n_dp}"
            )
        if fv.config.dim % n_tp:
            raise ValueError(f"dim {fv.config.dim} not divisible by tp={n_tp}")
        self.spmd = SpmdAxes(dp="dp", tp="tp", n_dp=n_dp, n_tp=n_tp)
        self._garr = replicate(fv._garr, mesh)

        iteration = fv._build_iteration_fn(self.spmd)
        device_train = fv._build_train_fn(iteration=iteration)

        from force2vec_tpu.train.trainer import make_train_dispatcher

        self.x_spec = P(None, "tp")

        def jit_for(k):
            sharded = jax.shard_map(
                lambda g, x, key, off: device_train(g, x, key, k, off),
                mesh=mesh,
                in_specs=(P(), self.x_spec, P(), P()),
                out_specs=self.x_spec,
                check_vma=False,
            )
            return jax.jit(sharded)

        self._train_jit = make_train_dispatcher(jit_for)

    def shard_embedding(self, x) -> jax.Array:
        """Place a [n_pad, D] embedding on the mesh with the P(None, tp)
        layout."""
        return jax.device_put(x, NamedSharding(self.mesh, self.x_spec))

    # runner protocol (train_with_checkpoints works on any schedule)
    @property
    def graph(self):
        return self.fv.graph

    @property
    def config(self):
        return self.fv.config

    def init_embedding(self, seed: int = 1) -> jax.Array:
        return self.shard_embedding(self.fv.init_embedding(seed))

    def pad_embedding(self, x) -> jax.Array:
        return self.shard_embedding(self.fv.pad_embedding(x))

    def unpad_embedding(self, x) -> np.ndarray:
        return self.fv.unpad_embedding(x)

    def train(
        self,
        iters: int,
        seed: int = 1,
        x0: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Train and return the [n, D] embedding (padding stripped)."""
        x = self.pad_embedding(x0) if x0 is not None else self.init_embedding(seed)
        key = jax.random.PRNGKey(seed)
        x = self._train_jit(self._garr, x, key, iters, 0)
        x.block_until_ready()
        return self.unpad_embedding(x)


class ShardedSyncForce2Vec:
    """The epoch-synchronous trainer over a (dp, tp) mesh.

    Each rank computes a contiguous 1/dp slice of every ELL bucket's rows
    (and of the repulsion rows); a tiled ``all_gather`` over ``dp``
    reassembles the full update on every rank, keeping X dp-replicated —
    semantics identical to the single-device sync step.  The embedding dim
    shards over ``tp`` exactly as in the batch runner.
    """

    def __init__(self, graph, config, mesh: Mesh, min_width=8, hub_width=256,
                 hot_rows=0):
        from force2vec_tpu.train.sync import SyncForce2Vec

        n_dp = mesh.shape["dp"]
        n_tp = mesh.shape["tp"]
        if config.dim % n_tp:
            raise ValueError(f"dim {config.dim} not divisible by tp={n_tp}")
        align = 8
        while align % n_dp:
            align *= 2
        # hot/cold gather split composes with dp: each rank
        # sweeps a 1/dp slice of every span chunk and the compact hot-suffix
        # copy is derived per-rank from the dp-replicated X.  span_align =
        # the dp-divisible row align so chunks split evenly across ranks.
        self.fv = SyncForce2Vec(
            graph, config, min_width=min_width, hub_width=hub_width,
            row_align=align, hot_rows=hot_rows, span_align=align,
        )
        self.mesh = mesh
        self.spmd = SpmdAxes(dp="dp", tp="tp", n_dp=n_dp, n_tp=n_tp)
        self._garr = replicate(self.fv._garr, mesh)

        iteration = self.fv._build_iteration_fn(self.spmd)
        device_train = self.fv._build_train_fn(iteration=iteration)

        from force2vec_tpu.train.trainer import make_train_dispatcher

        self.x_spec = P(None, "tp")

        def jit_for(k):
            sharded = jax.shard_map(
                lambda g, x, key, off: device_train(g, x, key, k, off),
                mesh=mesh,
                in_specs=(P(), self.x_spec, P(), P()),
                out_specs=self.x_spec,
                check_vma=False,
            )
            return jax.jit(sharded)

        self._train_jit = make_train_dispatcher(jit_for)

    # runner protocol (train_with_checkpoints works on any schedule)
    @property
    def graph(self):
        return self.fv.graph

    @property
    def config(self):
        return self.fv.config

    def init_embedding(self, seed: int = 1) -> jax.Array:
        x = self.fv.init_embedding(seed)
        return jax.device_put(x, NamedSharding(self.mesh, self.x_spec))

    def pad_embedding(self, x) -> jax.Array:
        x = self.fv.pad_embedding(x)
        return jax.device_put(x, NamedSharding(self.mesh, self.x_spec))

    def unpad_embedding(self, x) -> np.ndarray:
        return self.fv.unpad_embedding(x)

    def train(self, iters: int, seed: int = 1, x0: Optional[np.ndarray] = None):
        x = self.pad_embedding(x0) if x0 is not None else self.init_embedding(seed)
        key = jax.random.PRNGKey(seed)
        x = self._train_jit(self._garr, x, key, iters, 0)
        return self.unpad_embedding(x)
