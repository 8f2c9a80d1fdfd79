"""Epoch-synchronous trainer — the throughput schedule.

Semantically this is the reference's own training loop at ``batch_size =
n`` (one batch per iteration: every read sees iteration-start X, one apply
at the end — sample/algorithms.cpp:569-639 with NUMSIZE = n).  What the
batch-sequential schedule buys the reference on a CPU (cache locality) it
costs an accelerator dearly: hundreds of serial small steps per iteration.
The sync schedule turns one iteration into ONE fused device computation
over the degree-sorted ELL layout (graphs/csr.py::SyncLayout):

* per degree bucket: gather ``[count, K, D]`` neighbor rows, evaluate the
  force elementwise, mask the padding, reduce over K — a bandwidth-bound
  sweep that XLA fuses into one kernel per bucket, with no scatter;
* hub rows (deg > hub_width) arrive pre-split into virtual rows; their
  partials reduce into owner rows with one small segment-sum;
* per-vertex negative sampling (``[n, ns]`` — the ``-bs 1`` flavor of the
  reference, sample/algorithms.cpp:686-733) for repulsion, batched over
  the whole table;
* one apply: ``X += upd`` (or the energy-normalized update for the
  FR/LinLog/ForceAtlas family).

Everything runs in relabeled (degree-sorted) vertex order; the public API
permutes in and out.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from force2vec_tpu.dist.spmd import SpmdAxes
from force2vec_tpu.graphs.csr import Graph, SyncLayout
from force2vec_tpu.models.forces import get_model
from force2vec_tpu.train.trainer import TrainConfig


def masked_force_sum(model, kind, xi, xj, deg, invd, step, rsum=None):
    """Σ over the K slots of each row that are real (``k < deg``) of the
    edge (``kind='edge'``) or sample force: xi [C, D], xj [C, K, D] (any
    float dtype; computed in xi's), deg [C], invd [C] → [C, D]."""
    if xj.dtype != xi.dtype:  # low-precision gather replica
        xj = xj.astype(xi.dtype)
    kw = {} if rsum is None else {"rsum": rsum}
    mask = (jnp.arange(xj.shape[1], dtype=jnp.int32)[None, :]
            < deg[:, None])[:, :, None]
    if kind == "edge":
        f = model.edge_force(xi[:, None, :], xj, invd[:, None, None], step,
                             mask=mask, **kw)
    else:
        f = model.sample_force(xi[:, None, :], xj, step, mask=mask, **kw)
    return jnp.sum(f, axis=1)


class SyncForce2Vec:
    """Train with the epoch-synchronous schedule (one fused step/iter).

    Supports every sampled-repulsion model (tdist, sigmoid, rwalk, fr,
    linlog, forceatlas).  ``tdist_exact`` keeps the batch trainer (its
    O(n²) repulsion already runs as large fused chunks).
    """

    def __init__(
        self,
        graph: Graph,
        config: TrainConfig = TrainConfig(),
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        tile_budget_bytes: int = 1024 * 1024 * 1024,
        width_scheme: str = "mult8",
        hot_rows: int = 0,
        span_align: int = 8,
    ):
        self.graph = graph
        self.config = config
        self.model = get_model(config.model, sm_table=config.sm_table)
        if self.model.repulsion == "all":
            raise ValueError("tdist_exact uses the batch trainer, not sync mode")
        self.tile_budget_bytes = int(tile_budget_bytes)
        # hot_rows > 0 gathers the top-degree suffix from a compact copy of
        # the table (the hot/cold split, graphs/csr.py); off by default.
        # Walk models need the plain layout (the walk engine samples from
        # the ELL tables directly).
        self.hot_rows = int(hot_rows)
        # mult8 width ladder: bucket widths are multiples of 8, which pads
        # the bench graph's slots to 1.24x nnz (pow2: 1.39x).  Whether a
        # finer ladder pays on the GPU is an open question (PERF.md).
        self.layout = SyncLayout.build(
            graph, min_width=min_width, hub_width=hub_width,
            row_align=row_align,
            widths=SyncLayout.widths_for(min_width, hub_width, width_scheme),
            hot_rows=self.hot_rows, span_align=span_align,
        )
        self.lr = config.resolve_lr(self.model)
        self._dtype = jnp.dtype(config.dtype)

        lay = self.layout
        garr = {
            "inv_deg": jnp.asarray(
                1.0 / (lay.deg.astype(np.float64) + 1.0), dtype=self._dtype
            ),
        }
        for bi, b in enumerate(lay.buckets):
            garr[f"nbr{bi}"] = jnp.asarray(b.nbr)
            garr[f"deg{bi}"] = jnp.asarray(b.deg)
            if b.hot_spans is not None:
                garr[f"hotf{bi}"] = jnp.asarray(b.hot_flat)
                garr[f"hotdeg{bi}"] = jnp.asarray(b.hot_deg)
            if b.owners is not None:
                ol = b.owners - b.start
                garr[f"own{bi}"] = jnp.asarray(ol)
                # first virtual row per owner (owners' vrows are consecutive)
                first = np.zeros(max(lay.n_pad - b.start, 1), dtype=np.int32)
                u, idx = np.unique(ol, return_index=True)
                first[u] = idx.astype(np.int32)
                garr[f"first_vrow{bi}"] = jnp.asarray(first)
        if self.model.attraction == "walk":
            garr["deg_all"] = jnp.asarray(lay.deg)
            pool, base = _build_walk_tables(lay)
            garr["walk_pool"] = jnp.asarray(pool)
            # (deg, base) packed as one [n_pad, 2] table: the walk step
            # fetches both with ONE row take instead of two element gathers
            garr["walk_db"] = jnp.stack(
                [lay.deg.astype(np.int32), base], axis=1)
        self._garr = garr

        from force2vec_tpu.train.trainer import make_train_dispatcher

        self._iteration = self._build_iteration_fn()
        train = self._build_train_fn()
        # The jitted program CLOSES OVER the graph arrays instead of taking
        # them as parameters: as captured constants XLA owns their layout
        # and can hoist index-table preprocessing out of the loop, which it
        # cannot do for caller-supplied parameters.  Constants are embedded
        # in the compiled program, though, so they cost compile time, host
        # memory while compiling and persistent-cache space in proportion
        # to the graph: past 128 MB the runner passes garr as real
        # arguments instead.  Whether the closure still pays on the GPU is
        # an open question (PERF.md).
        garr_bytes = sum(int(v.size) * v.dtype.itemsize for v in garr.values())
        if garr_bytes <= 128 * 2**20:
            self._train_jit = make_train_dispatcher(
                lambda k: (
                    lambda jf: (lambda g, x, key, off: jf(x, key, off))
                )(jax.jit(lambda x, key, off: train(self._garr, x, key, k, off)))
            )
        else:
            self._train_jit = make_train_dispatcher(
                lambda k: jax.jit(lambda g, x, key, off: train(g, x, key, k, off))
            )

    def split_stats(self) -> dict:
        """Hot/cold gather-split accounting: how many padded slots each
        gather stream serves per iteration, so artifacts can show the split
        ACTIVE rather than assert it."""
        lay = self.layout
        hot = cold = rect = 0
        for b in lay.buckets:
            if b.hot_spans is None:
                rect += b.count * b.width
                continue
            for sp in b.hot_spans:
                hot += sp.rows_pad * sp.width
                cold += sp.rows_pad * sp.cold_width
        total = hot + cold + rect
        return {
            "hot_rows": self.hot_rows,
            "hot_start": lay.hot_start,
            "hot_slots_per_iter": hot,
            "cold_slots_per_iter": cold + rect,
            "hot_fraction": round(hot / total, 4) if total else 0.0,
            "spans": sum(len(b.hot_spans) for b in lay.buckets
                         if b.hot_spans),
        }

    # -- embedding layout ---------------------------------------------------

    def init_embedding(self, seed: int = 1) -> jnp.ndarray:
        key = jax.random.PRNGKey(seed)
        shape = (self.layout.n_pad, self.config.dim)
        if self.model.init == "uniform01":
            return jax.random.uniform(key, shape, dtype=self._dtype)
        return jax.random.uniform(key, shape, dtype=self._dtype, minval=-1.0, maxval=1.0)

    def pad_embedding(self, x: np.ndarray) -> jnp.ndarray:
        """Host [n, D] (original id order) → device [n_pad, D] relabeled."""
        x = np.asarray(x, dtype=self._dtype)
        out = np.zeros((self.layout.n_pad, self.config.dim), dtype=self._dtype)
        out[: self.graph.n] = x[self.layout.perm]
        return jnp.asarray(out)

    def unpad_embedding(self, x) -> np.ndarray:
        """Device [n_pad, D] relabeled → host [n, D] original order."""
        x = np.asarray(x)[: self.graph.n]
        return x[self.layout.inv_perm]

    # -- the fused iteration -------------------------------------------------

    def _build_iteration_fn(self, spmd: SpmdAxes = SpmdAxes()):
        lay, model, cfg = self.layout, self.model, self.config
        n_pad = lay.n_pad
        ns = cfg.ns
        assert cfg.dim % spmd.n_tp == 0
        dim = cfg.dim // spmd.n_tp
        rsum = spmd.make_rsum()

        # Buckets tile [0, n) contiguously in the degree-sorted order (the
        # hub bucket owns the tail range), so the attraction update is a
        # CONCATENATION of per-bucket results — no read-modify-write of the
        # full table.  Real (unpadded) extents are static.
        n = lay.n
        bucket_meta = []
        for bi, b in enumerate(lay.buckets):
            is_hub = b.owners is not None
            end = n if is_hub or bi == len(lay.buckets) - 1 else lay.buckets[bi + 1].start
            bucket_meta.append((bi, b.width, b.start, b.count, end - b.start, is_hub))
        wl = cfg.walk_length

        # dp sharding: each rank computes a contiguous 1/n_dp slice of every
        # bucket's rows (and of the repulsion rows); one tiled all_gather
        # per piece reassembles the full update on every rank.  X stays
        # dp-replicated, so the schedule's semantics are unchanged.
        n_dp, dp_axis = spmd.n_dp, spmd.dp

        gdt = None if cfg.gather_dtype is None else jnp.dtype(cfg.gather_dtype)

        # Each sweep piece gathers a [rows, K, dim] tile.  On big graphs one
        # bucket's tile can exceed the device memory (n=1.5M, K=64 → ~8 GB
        # if XLA materialises it), so every sweep is chunked: no single
        # tile may exceed this budget.  The chunks are independent slices
        # of the same bucket; their results concatenate in row order, so
        # semantics are unchanged.
        tile_budget_bytes = self.tile_budget_bytes
        gsize = (gdt or self._dtype).itemsize

        def chunk_spans(local: int, width: int, quant: int = 8):
            """Static [(row_offset, row_count)] covering [0, local)."""
            cap = tile_budget_bytes // max(width * dim * gsize, 1)
            cap = max(quant, (cap // quant) * quant)
            if local <= cap:
                return [(0, local)]
            return [(o, min(cap, local - o)) for o in range(0, local, cap)]

        def force_sum(kind, xi, xj, dg, invd, step):
            return masked_force_sum(model, kind, xi, xj, dg, invd, step, rsum)

        def shard_rows(total: int):
            """(local_count, offset_fn) for splitting `total` rows over dp."""
            assert total % n_dp == 0, (
                f"row count {total} not divisible by dp={n_dp}"
            )
            local = total // n_dp
            return local, lambda: spmd.dp_rank() * local

        def gathered(part_local):
            if dp_axis is None:
                return part_local
            return jax.lax.all_gather(part_local, dp_axis, axis=0, tiled=True)

        # Static piece list for the attraction sweep: every (bucket, chunk
        # span) pair, each with its own gather, which XLA fuses into that
        # piece's force reduction.  (Packing many pieces into one bulk
        # gather forces the gathered rows to materialise and, with many
        # small pieces, led XLA on the H100 to a slow multi-output reduce
        # fusion — PERF.md.)  With a hot/cold split layout the pieces come
        # in two streams: cold/rect pieces gather from the full table, hot
        # pieces from the compact hot-suffix copy.
        hot_start = lay.hot_start
        # dp + split: every span chunk must divide evenly across ranks.
        # Each chunk's rows are quantized to lcm(8, n_dp); the layout's
        # span_align (ShardedSyncForce2Vec passes its dp-divisible row
        # align) guarantees the stored rects round to that quantum too.
        import math as _math

        row_quant = (8 * n_dp) // _math.gcd(8, n_dp)
        if hot_start is not None and n_dp > 1:
            bad = [sp.rows_pad for b in lay.buckets if b.hot_spans
                   for sp in b.hot_spans if sp.rows_pad % row_quant]
            if bad:
                raise ValueError(
                    f"hot/cold split under dp={n_dp} needs span rects "
                    f"aligned to {row_quant} rows — rebuild the layout "
                    f"with span_align={row_quant} (got rect rows {bad[:3]}…)"
                )

        def build_pieces():
            cold, hot = [], []
            for bi, width, start, count, real, is_hub in bucket_meta:
                b = lay.buckets[bi]
                if b.hot_spans is None:
                    local = count // n_dp
                    for c_off, c_rows in chunk_spans(local, width):
                        cold.append(("rect", bi, width, start, count, real,
                                     is_hub, c_off, c_rows))
                    continue
                for si, sp in enumerate(b.hot_spans):
                    if sp.cold_width > 0:
                        for c_off, c_rows in chunk_spans(
                                sp.rows_pad, sp.cold_width, quant=row_quant):
                            real = min(sp.count - c_off, c_rows)
                            if real <= 0:
                                continue  # chunk holds only pad rows
                            cold.append((
                                "flat", bi, sp.cold_width, start,
                                sp.row_off + c_off, c_rows,
                                sp.cold_off + c_off * sp.cold_width,
                                sp.deg_off + c_off, real, "cold"))
                    if sp.width > 0:
                        for c_off, c_rows in chunk_spans(
                                sp.rows_pad, sp.width, quant=row_quant):
                            real = min(sp.count - c_off, c_rows)
                            if real <= 0:
                                continue
                            hot.append((
                                "flat", bi, sp.width, start,
                                sp.row_off + c_off, c_rows,
                                sp.flat_off + c_off * sp.width,
                                sp.deg_off + c_off, real, "hot"))
            return cold, hot

        cold_pieces, hot_pieces = build_pieces()

        def run_piece(g, x, src_tbl, pc, by_bucket, hot_adds, step):
            """Gather one piece's neighbour rows and sum their forces."""
            if pc[0] == "rect":
                _, bi, width, start, count, real, is_hub, c_off, c_rows = pc
                _, off = shard_rows(count)
                r0 = off() + jnp.int32(c_off)
                nbr = jax.lax.dynamic_slice(
                    g[f"nbr{bi}"], (r0, 0), (c_rows, width))
                xj = jnp.take(src_tbl, nbr.reshape(-1), axis=0).reshape(
                    c_rows, width, dim)
                dg = jax.lax.dynamic_slice(g[f"deg{bi}"], (r0,), (c_rows,))
                if is_hub:
                    owners = jax.lax.dynamic_slice(
                        g[f"own{bi}"], (r0,), (c_rows,))
                    xi = jnp.take(x, owners + jnp.int32(start), axis=0)
                    invd = jnp.take(g["inv_deg"], owners + jnp.int32(start))
                else:
                    xi = jax.lax.dynamic_slice(
                        x, (start + r0, 0), (c_rows, dim))
                    invd = jax.lax.dynamic_slice(
                        g["inv_deg"], (start + r0,), (c_rows,))
                by_bucket.setdefault(bi, []).append(
                    force_sum("edge", xi, xj, dg, invd, step))
                return
            (_, bi, width, start, row_off, c_rows, f_off,
             deg_pos, real, src) = pc
            key = f"hotf{bi}" if src == "hot" else f"nbr{bi}"
            # dp: each rank takes/sweeps a contiguous 1/n_dp row slice of
            # the chunk; the all_gather reassembles before the [:real] trim
            loc = c_rows // n_dp
            r0 = spmd.dp_rank() * jnp.int32(loc)
            idx = jax.lax.dynamic_slice(
                g[key], (jnp.int32(f_off) + r0 * width,), (loc * width,))
            xj = jnp.take(src_tbl, idx, axis=0).reshape(loc, width, dim)
            dkey = f"hotdeg{bi}" if src == "hot" else f"deg{bi}"
            dg = jax.lax.dynamic_slice(
                g[dkey], (jnp.int32(deg_pos) + r0,), (loc,))
            xi = jax.lax.dynamic_slice(
                x, (jnp.int32(start + row_off) + r0, 0), (loc, dim))
            invd = jax.lax.dynamic_slice(
                g["inv_deg"], (jnp.int32(start + row_off) + r0,), (loc,))
            res = gathered(force_sum("edge", xi, xj, dg, invd, step))[:real]
            if src == "hot":
                hot_adds.setdefault(bi, []).append((row_off, res))
            else:
                by_bucket.setdefault(bi, []).append((row_off, res))

        def attraction(g, x, xg, step):
            """Σ_buckets masked ELL force — returns the [n_pad, dim] update."""
            by_bucket, hot_adds = {}, {}
            for pc in cold_pieces:
                run_piece(g, x, xg, pc, by_bucket, hot_adds, step)
            if hot_pieces:
                # optimization_barrier makes the suffix copy MATERIALIZE as
                # its own compact buffer; without it XLA folds the slice
                # into the gathers (an index offset into the big table)
                xg_hot = jax.lax.optimization_barrier(
                    jax.lax.slice(xg, (hot_start, 0), (n_pad, dim)))
                for pc in hot_pieces:
                    run_piece(g, x, xg_hot, pc, by_bucket, hot_adds, step)
            parts = []
            for bi, width, start, count, real, is_hub in bucket_meta:
                b = lay.buckets[bi]
                chunks = by_bucket.get(bi, [])
                if b.hot_spans is None:
                    part = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks)
                    part = gathered(part)  # [count, dim] on every rank
                else:
                    # cold chunks carry (row_off, res); spans with no cold
                    # slots contribute zeros
                    by_off = {ro: r for ro, r in chunks}
                    seq, cursor = [], 0
                    for ro in sorted(by_off):
                        if ro > cursor:
                            seq.append(jnp.zeros((ro - cursor, dim), x.dtype))
                        seq.append(by_off[ro])
                        cursor = ro + by_off[ro].shape[0]
                    if cursor < count:
                        seq.append(jnp.zeros((count - cursor, dim), x.dtype))
                    part = seq[0] if len(seq) == 1 else jnp.concatenate(seq)
                    for ro, res in hot_adds.get(bi, []):
                        part = part.at[ro:ro + res.shape[0]].add(res)
                if is_hub:
                    part = jax.ops.segment_sum(part, g[f"own{bi}"], num_segments=real)
                else:
                    part = part[:real]  # drop alignment-padding rows (static)
                parts.append(part)
            if n_pad > n:
                parts.append(jnp.zeros((n_pad - n, dim), dtype=x.dtype))
            return jnp.concatenate(parts, axis=0)

        def attraction_walk(g, x, xg, walks, step):
            local, off = shard_rows(n_pad)
            base = off()
            chunks = []
            for c_off, c_rows in chunk_spans(local, wl):
                r0 = base + jnp.int32(c_off)
                wb = jax.lax.dynamic_slice(walks, (r0, 0), (c_rows, wl))
                xi = jax.lax.dynamic_slice(x, (r0, 0), (c_rows, dim))
                invd = jax.lax.dynamic_slice(g["inv_deg"], (r0,), (c_rows,))
                xj = jnp.take(xg, wb.reshape(-1), axis=0).reshape(c_rows, wl, dim)
                full = jnp.full((c_rows,), wl, dtype=jnp.int32)
                chunks.append(force_sum("edge", xi, xj, full, invd, step))
            part = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks)
            return gathered(part)

        group = max(cfg.batch_size, 1)

        def repulsion(x, xg, negs, step):
            local, off = shard_rows(n_pad)
            r0 = off()
            # With a gather replica, both sides of a sample pair are taken
            # at its precision: a sample that hits its own row then has
            # exactly zero distance and, as on the f32 path, zero force
            # (full-precision xi against a rounded copy of itself gives a
            # tiny distance and a clamped, maximal tdist force).
            # reduce_precision, unlike a convert round trip, is not removed
            # by XLA's excess-precision simplification.
            if gdt is None:
                at_replica = lambda v: v  # noqa: E731
            else:
                fi = jnp.finfo(gdt)
                at_replica = lambda v: jax.lax.reduce_precision(  # noqa: E731
                    v.astype(x.dtype), exponent_bits=fi.nexp,
                    mantissa_bits=fi.nmant)
            if negs.shape[0] == n_pad:
                # per-row samples ([n_pad, ns]): bulk gathers, chunked
                base = r0
                chunks = []
                for c_off, c_rows in chunk_spans(local, ns):
                    r0c = base + jnp.int32(c_off)
                    xi = at_replica(jax.lax.dynamic_slice(
                        x, (r0c, 0), (c_rows, dim)))
                    nb = jax.lax.dynamic_slice(negs, (r0c, 0), (c_rows, ns))
                    s = at_replica(jnp.take(xg, nb.reshape(-1), axis=0)
                                   ).reshape(c_rows, ns, dim)
                    full = jnp.full((c_rows,), ns, dtype=jnp.int32)
                    invd0 = jnp.zeros((c_rows,), dtype=x.dtype)
                    chunks.append(
                        force_sum("sample", xi, s, full, invd0, step)
                    )
                part = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks)
                return gathered(part)
            # grouped samples ([ng, ns]): each batch_size-row group shares
            # one ns-sample set — the reference's own option-5 sampling
            # pattern (sample/algorithms.cpp:577-586), and the repulsion
            # gather collapses from n·ns rows to ng·ns rows.  XLA fuses the
            # [local, ns, D] group expand into the force reduction.
            xi = at_replica(jax.lax.dynamic_slice(x, (r0, 0), (local, dim)))
            sg = at_replica(jnp.take(xg, negs.reshape(-1), axis=0)).reshape(
                negs.shape[0], ns, dim
            )
            gid = (r0 + jnp.arange(local, dtype=jnp.int32)) // jnp.int32(group)
            s = jnp.take(sg, gid, axis=0)
            full = jnp.full((local,), ns, dtype=jnp.int32)
            invd0 = jnp.zeros((local,), dtype=x.dtype)
            return gathered(force_sum("sample", xi, s, full, invd0, step))

        def iteration(garr, x, negs, walks, step):
            step = jnp.asarray(step, dtype=x.dtype)
            xg = x if gdt is None else x.astype(gdt)
            if model.attraction == "walk":
                upd = attraction_walk(garr, x, xg, walks, step)
            else:
                upd = attraction(garr, x, xg, step)
            upd = upd + repulsion(x, xg, negs, step)
            if model.update == "energy":
                fnorm = rsum(upd * upd)
                safe = jnp.where(fnorm > 0, fnorm, 1.0)
                factor = jnp.where(fnorm > 0, step / jnp.sqrt(safe), 0.0)
                return x + factor * upd
            return x + upd

        return iteration

    def _build_train_fn(self, iteration=None):
        lay, model, cfg = self.layout, self.model, self.config
        iteration = iteration or self._iteration
        lr = self.lr
        n_pad = lay.n_pad

        def draw(garr, key, it):
            kit = jax.random.fold_in(key, it)
            nkey = jax.random.fold_in(kit, 0)
            if cfg.per_vertex_samples:
                negs = jax.random.randint(
                    nkey, (n_pad, cfg.ns), 0, max(lay.n - 1, 1), dtype=jnp.int32
                )
            else:
                # batch-shared samples — the reference's default flavor
                # (one ns-sample set per batch of batch_size vertices,
                # sample/algorithms.cpp:577-586); grouped over the
                # relabeled row order here
                ng = -(-n_pad // max(cfg.batch_size, 1))
                negs = jax.random.randint(
                    nkey, (ng, cfg.ns), 0, max(lay.n - 1, 1), dtype=jnp.int32
                )
            walks = None
            if model.attraction == "walk":
                # walk over the relabeled ELL graph: L uniform-neighbor steps
                wkey = jax.random.fold_in(kit, 1)
                walks = _ell_walks(garr, lay, wkey, cfg.walk_length)
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

    def run_iteration(self, x, neg_ids, walks=None, step=None):
        """One iteration with injected [n_pad, ns] negatives (relabeled ids)
        and optional [n_pad, L] walks — the parity-test entry point."""
        if step is None:
            step = self.lr
        w = None if walks is None else jnp.asarray(walks, dtype=jnp.int32)
        return self._iteration(
            self._garr, jnp.asarray(x), jnp.asarray(neg_ids, dtype=jnp.int32), w, step
        )

    def train(
        self,
        iters: int = 1200,
        seed: int = 1,
        x0: Optional[np.ndarray] = None,
        verbose: bool = False,
    ) -> np.ndarray:
        x = self.pad_embedding(x0) if x0 is not None else self.init_embedding(seed)
        key = jax.random.PRNGKey(seed)
        t0 = time.perf_counter()
        x = self._train_jit(self._garr, x, key, iters, 0)
        out = self.unpad_embedding(x)  # forces completion
        self.last_train_seconds = time.perf_counter() - t0
        if verbose:
            ups = (self.graph.nnz + self.graph.n * self.config.ns) * iters
            print(
                f"sync {iters} iters in {self.last_train_seconds:.2f}s  "
                f"{ups / self.last_train_seconds / 1e6:.1f}M updates/s"
            )
        return out


def _build_walk_tables(lay: SyncLayout):
    """(pool, base): flat neighbor pool (every bucket's ELL rectangle,
    concatenated) + per-relabeled-row base offset so that the walk step's
    (vertex, slot) -> neighbor lookup is ``pool[base[v] + slot]``.

    Exact for hubs too: an owner's virtual rows are CONSECUTIVE and each
    holds ``width`` slots, so ``vrow*width + col == first_vrow*width +
    slot`` — the flat pool linearizes the whole CSR row.  Requires the
    plain (unsplit) layout; walk models build with hot_rows=0.

    Why: a per-step lookup that where-chains a gather over every bucket
    table costs ~15 two-index gathers per step; one 1-D gather per step
    replaces all of it.
    """
    assert lay.hot_start is None, "walk tables need the unsplit layout"
    base = np.zeros(lay.n_pad, dtype=np.int64)
    pools = []
    off = 0
    for b in lay.buckets:
        pools.append(b.nbr.reshape(-1))
        if b.owners is None:
            rows = np.arange(b.count, dtype=np.int64)
            base[b.start + rows] = off + rows * b.width
        else:
            # first virtual row per owner (owners' vrows are consecutive)
            u, idx = np.unique(b.owners, return_index=True)
            base[u] = off + idx.astype(np.int64) * b.width
        off += b.nbr.size
    pool = (np.concatenate(pools) if pools
            else np.zeros(1, dtype=np.int32)).astype(np.int32)
    return pool, base.astype(np.int32)


def _ell_walks(garr, lay: SyncLayout, key, walk_length: int):
    """Vectorized L-step uniform walks over the bucketed ELL adjacency
    (relabeled space).  Each step: draw a slot in [0, deg), then ONE flat
    gather ``pool[base[v] + slot]`` (see :func:`_build_walk_tables`);
    stay-in-place for degree-0 rows (divergence from the reference's
    quirky deg<2 path documented in sampling/walks.py)."""
    n_pad = lay.n_pad
    start = jnp.arange(n_pad, dtype=jnp.int32)
    pool = garr["walk_pool"]
    db = garr["walk_db"]  # [n_pad, 2] = (deg, base)

    def step_fn(carry, step_key):
        w = carry
        r = jax.random.randint(
            step_key, (n_pad,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32
        )
        row = jnp.take(db, w, axis=0)  # one row take for (deg, base)
        d, base_w = row[:, 0], row[:, 1]
        slot = r % jnp.maximum(d, 1)
        nxt = jnp.take(pool, base_w + slot)
        nxt = jnp.where(d > 0, nxt, w)
        return nxt, nxt

    keys = jax.random.split(key, walk_length)
    _, targets = jax.lax.scan(step_fn, start, keys)
    return jnp.transpose(targets)
