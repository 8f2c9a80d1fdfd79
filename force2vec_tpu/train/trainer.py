"""The Force2Vec training loop (the reference's batch-sequential schedule).

One jitted function runs the *entire* multi-iteration training:

* iterations and batches are ``lax.fori_loop``s over the embedding
  carry — the whole run is a single device program, no per-step host
  dispatch (the reference instead forks/joins OpenMP twice per batch,
  sample/algorithms.cpp:588-639);
* a minibatch is a contiguous ``[B, D]`` slice of the padded embedding
  table, so the batch read and the batch update are static-shape
  ``dynamic_slice`` / ``dynamic_update_slice`` — no scatter;
* the batch's CSR edges (one contiguous ``colids`` span) are walked in
  fixed-size chunks: gather neighbor rows, evaluate the force model
  elementwise, segment-reduce into batch rows (ops/segment.py).
  The edge-centric chunk schedule is load-balanced by construction — the
  device-side answer to the reference's per-thread nnz partitioning
  (sample/algorithms.cpp:2483-2511);
* batch-update semantics match the reference exactly: every read within a
  batch sees the pre-batch embedding, updates apply at batch end, and batch
  b+1 observes them (sample/algorithms.cpp:569-639);
* graph arrays (rowptr/colids/edge_src/inv_deg) are closed over as
  constants of the jitted program (see ``Force2Vec.__init__``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from force2vec_tpu.dist.spmd import SpmdAxes
from force2vec_tpu.graphs.csr import DeviceGraph, Graph
from force2vec_tpu.models.forces import ForceModel, get_model
from force2vec_tpu.ops.segment import segment_sum_into_batch
from force2vec_tpu.sampling.negative import per_vertex_windows, sample_negative_ids
from force2vec_tpu.sampling.walks import sample_walks


def make_train_dispatcher(build_jit_for_count):
    """Runner-protocol train entry ``(garr, x, key, num_iters, iter_offset)``
    that specializes the compiled program per ITERATION COUNT.

    A static ``fori_loop`` trip count gives XLA a fixed loop to schedule,
    and an undonated carry (ping-pong buffers) leaves it free to overlap
    iteration i+1's gathers with iteration i's tail; both choices came from
    measurements on earlier hardware and are open questions on the GPU
    (PERF.md).  So every runner compiles one program per distinct span
    length (there are one or two per training run) with NO donation,
    cached here.

    ``build_jit_for_count(k)`` must return a jitted ``fn(garr, x, key,
    iter_offset)`` running exactly ``k`` iterations.
    """
    cache = {}

    def dispatch(garr, x, key, num_iters, iter_offset=0):
        k = int(num_iters)
        if k not in cache:
            cache[k] = build_jit_for_count(k)
        return cache[k](garr, x, key, iter_offset)

    return dispatch


def _auto_edge_chunk(graph: Graph, num_batches: int) -> int:
    mean_batch_edges = max(1, graph.nnz // max(num_batches, 1))
    chunk = ((mean_batch_edges + 511) // 512) * 512
    return int(min(8192, max(512, chunk)))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (CLI-flag parity noted per field)."""

    dim: int = 128  # -dim
    batch_size: int = 384  # -batch
    model: str = "tdist"  # -option (see models.forces.OPTION_TO_MODEL)
    ns: int = 5  # -nsamples
    lr: Optional[float] = None  # -lr (None → model default)
    per_vertex_samples: bool = False  # -bs 1
    walk_length: int = 5  # WALKLENGTH (sample/algorithms.cpp:1073)
    edge_chunk: Optional[int] = None  # device edge-tile size (None → auto)
    rep_chunk: int = 512  # row-tile for exact O(n²) repulsion
    segment_mode: str = "scatter"  # 'scatter' | 'matmul' (ops/segment.py)
    dtype: str = "float32"
    # Mixed-precision gathers (sync schedule): keep X in ``dtype`` for the
    # exact SGD apply, but feed the random neighbor/sample gathers — the
    # HBM-bandwidth-bound core (SURVEY.md §3.2) — from a low-precision
    # replica cast once per iteration.  'bfloat16' halves gather traffic;
    # force math still runs in ``dtype``.  None disables the replica.
    gather_dtype: Optional[str] = None
    # Reference fast_SM parity mode: sigmoid family evaluates σ via the
    # 2048-entry lookup table (sample/algorithms.cpp:755-776) instead of
    # the exact sigmoid.
    sm_table: bool = False

    def resolve_lr(self, model: ForceModel) -> float:
        return model.default_lr if self.lr is None else self.lr


class Force2Vec:
    """Train force-directed graph embeddings (batch-sequential schedule).

    Example::

        fv = Force2Vec(graph, TrainConfig(dim=128, batch_size=256, model="tdist"))
        emb = fv.train(iters=1200, seed=1)     # -> np.ndarray [n, 128]
    """

    def __init__(self, graph: Graph, config: TrainConfig = TrainConfig()):
        self.graph = graph
        self.config = config
        self.model = get_model(config.model, sm_table=config.sm_table)
        b = min(config.batch_size, graph.n)
        nb = -(-graph.n // b)
        chunk = config.edge_chunk or _auto_edge_chunk(graph, nb)
        self.dg = DeviceGraph.build(graph, config.batch_size, edge_chunk=chunk)
        self.lr = config.resolve_lr(self.model)
        self._dtype = jnp.dtype(config.dtype)

        dg = self.dg
        self._garr = {
            "rowptr": jnp.asarray(dg.rowptr),
            "colids": jnp.asarray(dg.colids),
            "edge_src": jnp.asarray(dg.edge_src),
            "inv_deg": jnp.asarray(1.0 / (dg.deg + 1.0), dtype=self._dtype),
        }

        self._iteration = self._build_iteration_fn()
        train = self._build_train_fn()
        # Close over the graph arrays (captured constants) rather than pass
        # them as jit parameters: XLA then owns their layout and can hoist
        # index preprocessing out of the loop (see train/sync.py).  The
        # ``g`` runner-protocol argument is accepted and ignored.
        self._train_jit = make_train_dispatcher(
            lambda k: (
                lambda jf: (lambda g, x, key, off: jf(x, key, off))
            )(jax.jit(lambda x, key, off: train(self._garr, x, key, k, off)))
        )

    # -- initialization ----------------------------------------------------

    def init_embedding(self, seed: int = 1) -> jnp.ndarray:
        """Random init on the padded table: U(0,1) for sigmoid-family models
        (randInit, sample/algorithms.cpp:38-45), U(-1,1) otherwise
        (randInitF, sample/algorithms.cpp:47-53)."""
        key = jax.random.PRNGKey(seed)
        shape = (self.dg.n_pad, self.config.dim)
        if self.model.init == "uniform01":
            return jax.random.uniform(key, shape, dtype=self._dtype)
        return jax.random.uniform(key, shape, dtype=self._dtype, minval=-1.0, maxval=1.0)

    def pad_embedding(self, x: np.ndarray) -> jnp.ndarray:
        """Pad a host [n, D] embedding to the device layout [n_pad, D]."""
        x = np.asarray(x, dtype=self._dtype)
        out = np.zeros((self.dg.n_pad, self.config.dim), dtype=self._dtype)
        out[: self.graph.n] = x
        return jnp.asarray(out)

    def unpad_embedding(self, x) -> np.ndarray:
        """Device [n_pad, D] → host [n, D] (the batch layout keeps original
        vertex order; padding rows are simply dropped)."""
        return np.asarray(x)[: self.graph.n]

    # -- single iteration (exposed for parity tests) ------------------------

    def _build_iteration_fn(self, spmd: SpmdAxes = SpmdAxes()):
        """Build the one-iteration step ``iteration(garr, x, negs, walks,
        step)``.

        With the default ``spmd`` this is the single-device step.  Under a
        non-trivial ``SpmdAxes`` the *same* code becomes the per-device body
        of a ``shard_map``: batch rows (and their contiguous CSR edge spans)
        split over the ``dp`` axis, the embedding dim over ``tp``; per-edge
        scalar reductions psum over ``tp`` via the ``rsum`` hook and the
        disjoint per-rank row updates merge with one psum over ``dp``.
        """
        dg, model, cfg = self.dg, self.model, self.config
        b_size, n_pad = dg.batch_size, dg.n_pad
        chunk, ns = dg.edge_chunk, cfg.ns
        num_batches = dg.num_batches
        n_real = dg.n
        per_vertex = cfg.per_vertex_samples
        rep_chunk = min(cfg.rep_chunk, n_pad)
        windows = per_vertex_windows(b_size, ns) if per_vertex else None

        # Per-device extents: rows per dp rank, embedding dims per tp rank.
        assert b_size % spmd.n_dp == 0, "batch size must divide over dp"
        assert cfg.dim % spmd.n_tp == 0, "dim must divide over tp"
        b_local = b_size // spmd.n_dp
        dim = cfg.dim // spmd.n_tp
        rsum = spmd.make_rsum()

        def attraction_csr(g, x, xb, invdeg_b, b0, r0, step):
            # This rank's rows form a contiguous id range, so its edges form
            # one contiguous colids span — walked in fixed-size chunks.
            chunk_iota = jnp.arange(chunk, dtype=jnp.int32)
            e0 = g["rowptr"][r0]
            e1 = g["rowptr"][r0 + b_local]
            nchunks = (e1 - e0 + chunk - 1) // chunk

            def chunk_body(k, acc):
                offs = e0 + k * chunk
                dst = jax.lax.dynamic_slice(g["colids"], (offs,), (chunk,))
                src = jax.lax.dynamic_slice(g["edge_src"], (offs,), (chunk,))
                valid = (offs + chunk_iota) < e1
                src_local = jnp.clip(src - b0, 0, b_size - 1)
                xi = jnp.take(xb, src_local, axis=0)
                xj = jnp.take(x, dst, axis=0)
                f = model.edge_force(
                    xi, xj, invdeg_b[src_local][:, None], step, rsum=rsum
                )
                return acc + segment_sum_into_batch(
                    f, src_local, valid, b_size, mode=cfg.segment_mode
                )

            acc0 = jnp.zeros((b_size, dim), dtype=x.dtype)
            return jax.lax.fori_loop(0, nchunks, chunk_body, acc0)

        def paste_rows(acc_local, r0_local):
            """Place this rank's [b_local, dim] rows into the full [B, dim]
            batch buffer (zeros elsewhere) so one dp-psum merges ranks."""
            if spmd.n_dp == 1:
                return acc_local
            buf = jnp.zeros((b_size, dim), dtype=acc_local.dtype)
            return jax.lax.dynamic_update_slice(buf, acc_local, (r0_local, 0))

        def attraction_walk(x, xb, invdeg_b, r0, r0_local, walks, step):
            wb = jax.lax.dynamic_slice(walks, (r0, 0), (b_local, cfg.walk_length))
            xr = jax.lax.dynamic_slice(xb, (r0_local, 0), (b_local, dim))
            ir = jax.lax.dynamic_slice(invdeg_b, (r0_local,), (b_local,))
            xj = jnp.take(x, wb.reshape(-1), axis=0).reshape(
                b_local, cfg.walk_length, dim
            )
            f = model.edge_force(
                xr[:, None, :], xj, ir[:, None, None], step, rsum=rsum
            )
            return paste_rows(jnp.sum(f, axis=1), r0_local)

        def repulsion_sampled(x, xb, r0_local, neg, step):
            s = jnp.take(x, neg, axis=0)
            xr = jax.lax.dynamic_slice(xb, (r0_local, 0), (b_local, dim))
            if per_vertex:
                win = jax.lax.dynamic_slice(windows, (r0_local, 0), (b_local, ns))
                sv = jnp.take(s, win.reshape(-1), axis=0).reshape(b_local, ns, dim)
            else:
                sv = s[None, :, :]
            f = model.sample_force(xr[:, None, :], sv, step, rsum=rsum)
            return paste_rows(jnp.sum(f, axis=1), r0_local)

        def repulsion_all(x, xb, r0, r0_local, step):
            # exact O(n²) repulsion vs every real vertex j != i
            # (AlgoForce2Vec, sample/algorithms.cpp:399-422)
            row_gid = r0 + jnp.arange(b_local, dtype=jnp.int32)
            xr = jax.lax.dynamic_slice(xb, (r0_local, 0), (b_local, dim))

            def rep_body(k, acc):
                c0 = k * rep_chunk
                xc = jax.lax.dynamic_slice(x, (c0, 0), (rep_chunk, dim))
                jid = c0 + jnp.arange(rep_chunk, dtype=jnp.int32)
                f = model.sample_force(xr[:, None, :], xc[None, :, :], step, rsum=rsum)
                valid = (jid[None, :] < n_real) & (jid[None, :] != row_gid[:, None])
                return acc + jnp.sum(jnp.where(valid[:, :, None], f, 0), axis=1)

            acc0 = jnp.zeros((b_local, dim), dtype=x.dtype)
            out = jax.lax.fori_loop(0, n_pad // rep_chunk, rep_body, acc0)
            return paste_rows(out, r0_local)

        def batch_body(g, x, b, negs, walks, step):
            b0 = b * b_size
            r0_local = spmd.dp_rank() * b_local  # this rank's offset in batch
            r0 = b0 + r0_local  # ... and in the vertex id space
            xb = jax.lax.dynamic_slice(x, (b0, 0), (b_size, dim))
            invdeg_b = jax.lax.dynamic_slice(g["inv_deg"], (b0,), (b_size,))

            if model.attraction == "walk":
                acc = attraction_walk(x, xb, invdeg_b, r0, r0_local, walks, step)
            else:
                acc = attraction_csr(g, x, xb, invdeg_b, b0, r0, step)

            if model.repulsion == "all":
                acc = acc + repulsion_all(x, xb, r0, r0_local, step)
            else:
                neg = jax.lax.dynamic_index_in_dim(negs, b, axis=0, keepdims=False)
                acc = acc + repulsion_sampled(x, xb, r0_local, neg, step)

            # Merge the disjoint per-rank row updates; every dp rank then
            # applies the full batch update, keeping X dp-replicated.
            acc = spmd.psum_dp(acc)

            if model.update == "energy":
                # energy-normalized apply (sample/algorithms.cpp:224-239);
                # the row norm spans the full (tp-sharded) dim via rsum.
                fnorm = rsum(acc * acc)
                safe = jnp.where(fnorm > 0, fnorm, 1.0)
                factor = jnp.where(fnorm > 0, step / jnp.sqrt(safe), 0.0)
                xb = xb + factor * acc
            else:
                xb = xb + acc
            return jax.lax.dynamic_update_slice(x, xb, (b0, 0))

        def iteration(garr, x, negs, walks, step):
            """One full pass over all batches (batch-sequential carry)."""
            step = jnp.asarray(step, dtype=x.dtype)
            return jax.lax.fori_loop(
                0,
                num_batches,
                lambda b, xc: batch_body(garr, xc, b, negs, walks, step),
                x,
            )

        return iteration

    def _build_train_fn(self, iteration=None):
        """Multi-iteration train fn ``train(garr, x, key, num_iters,
        iter_offset)`` over a given iteration body (defaults to the
        single-device one; the sharded runner passes an SPMD body)."""
        dg, model, cfg = self.dg, self.model, self.config
        iteration = iteration or self._iteration
        lr = self.lr

        def draw(garr, key, it):
            kit = jax.random.fold_in(key, it)
            negs = (
                None
                if model.repulsion == "all"
                else sample_negative_ids(
                    jax.random.fold_in(kit, 0),
                    dg.num_batches,
                    dg.batch_size,
                    cfg.ns,
                    dg.n,
                    per_vertex=cfg.per_vertex_samples,
                    neg_range=model.neg_range,
                )
            )
            walks = (
                sample_walks(
                    jax.random.fold_in(kit, 1),
                    garr["rowptr"],
                    garr["colids"],
                    dg.n_pad,
                    cfg.walk_length,
                )
                if model.attraction == "walk"
                else None
            )
            return negs, walks

        def train(garr, x, key, num_iters, iter_offset):
            def body(t, xc):
                it = iter_offset + t
                negs, walks = draw(garr, key, it)
                if model.lr_schedule == "decay999":
                    step = lr * jnp.power(jnp.float32(0.999), it).astype(x.dtype)
                else:
                    step = jnp.asarray(lr, dtype=x.dtype)
                return iteration(garr, xc, negs, walks, step)

            return jax.lax.fori_loop(0, num_iters, body, x)

        return train

    # -- public API ----------------------------------------------------------

    def run_iteration(self, x, neg_ids=None, walks=None, step=None):
        """One iteration with *injected* negatives/walks — the parity-test
        entry point (SURVEY.md §4: parity is defined over injected samples).

        neg_ids: [num_batches, M] int32; walks: [n_pad, L] int32.
        """
        if step is None:
            step = self.lr
        negs = None if neg_ids is None else jnp.asarray(neg_ids, dtype=jnp.int32)
        w = None if walks is None else jnp.asarray(walks, dtype=jnp.int32)
        return self._iteration(self._garr, jnp.asarray(x), negs, w, step)

    def train(
        self,
        iters: int = 1200,
        seed: int = 1,
        x0: Optional[np.ndarray] = None,
        iters_per_call: int = 0,
        verbose: bool = False,
    ) -> np.ndarray:
        """Run training and return the [n, D] embedding (padding stripped).

        ``iters_per_call`` > 0 splits the run into host-visible spans (for
        logging/checkpoint callbacks); 0 runs everything in one device call.
        """
        x = self.pad_embedding(x0) if x0 is not None else self.init_embedding(seed)
        key = jax.random.PRNGKey(seed)
        span = iters_per_call if iters_per_call > 0 else iters
        done = 0
        t_start = time.perf_counter()
        while done < iters:
            k = min(span, iters - done)
            x = self._train_jit(self._garr, x, key, k, done)
            done += k
            if verbose:
                x.block_until_ready()
                dt = time.perf_counter() - t_start
                eps = self.graph.nnz * done / max(dt, 1e-9)
                print(f"iter {done}/{iters}  {dt:.2f}s  {eps/1e6:.1f}M edges/s")
        x.block_until_ready()
        self.last_train_seconds = time.perf_counter() - t_start
        return np.asarray(x[: self.graph.n])
