"""Vertex-sharded training: X partitioned over a ``vp`` mesh axis with a
static halo exchange — the scale-out mode for graphs whose embedding table
outgrows one device's memory.

The reference has no distributed analog (single address space, SURVEY.md
§5); this is the design BASELINE.json's north star asks for: a 1-D vertex
partition of the embedding table, each shard computing forces for its own
rows, with the remote neighbor rows it reads ("the halo") delivered once
per iteration by ONE ``lax.all_to_all``.  Per iteration, per
shard:

1. build the send buffer ``x_loc[send_idx]`` — one gather;
2. ``all_to_all`` over ``vp`` → halo buffer ``[P·H, D]``;
3. per degree-bucket ELL force sweep over ``concat([x_loc, halo])`` —
   identical math to the single-chip sync schedule (train/sync.py);
4. repulsion against a small global sample pool assembled by a masked
   ``psum`` (every shard contributes the pool rows it owns);
5. apply: ``x_loc += upd_loc`` — updates are owner-local by construction,
   so the apply needs NO collective at all.

Semantics in ``shared`` sampling mode are exactly the epoch-synchronous
schedule's (= the reference's loop at batch_size = n with its default
batch-shared negatives, sample/algorithms.cpp:569-639): the parity test
asserts allclose against :class:`~force2vec_tpu.train.sync.SyncForce2Vec`.
In ``pool`` mode each vertex draws its ``ns`` negatives from a
``neg_pool``-row global pool per iteration — the scale-out flavor of the
reference's per-vertex ``-bs 1`` sampling (a pool is what keeps the
exchange static-shape; divergence documented here, quality-gated in
tests/test_vertex_sharded.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from force2vec_tpu.graphs.csr import Graph
from force2vec_tpu.graphs.partition import VertexShardLayout
from force2vec_tpu.models.forces import get_model
from force2vec_tpu.train.sync import masked_force_sum
from force2vec_tpu.train.trainer import TrainConfig


def make_vp_mesh(devices=None) -> Mesh:
    """1-D ``vp`` mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), axis_names=("vp",))


class VertexShardedForce2Vec:
    """Train with X vertex-sharded over a 1-D ``vp`` mesh."""

    def __init__(
        self,
        graph: Graph,
        config: TrainConfig = TrainConfig(),
        mesh: Optional[Mesh] = None,
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        sampling: str = "shared",
        neg_pool: int = 128,
        walk_fetch: str = "auto",
        walk_fetch_cap: Optional[int] = None,
        walk_fetch_slack: float = 1.5,
        halo_stale: bool = False,
    ):
        self.graph = graph
        self.config = config
        self.model = get_model(config.model, sm_table=config.sm_table)
        if self.model.repulsion == "all":
            raise ValueError("tdist_exact runs the batch trainer, not vertex-sharded")
        if sampling not in ("shared", "pool"):
            raise ValueError(f"sampling must be 'shared' or 'pool', got {sampling!r}")
        self.mesh = mesh if mesh is not None else make_vp_mesh()
        self.P = self.mesh.shape["vp"]
        self.sampling = sampling
        self.neg_pool = int(neg_pool)
        # Iteration-pipelined halo exchange: issue
        # iteration i's cold all_to_all / hot all_gather from x_i but
        # CONSUME the buffers exchanged at iteration i-1 — the collective
        # has no same-iteration consumer, so XLA's async-collective
        # machinery can fly it under the whole sweep.  Halo-dependent
        # slabs then read neighbor rows one iteration stale, which is the
        # reference's own Hogwild-adjacent cross-batch semantics
        # (sample/algorithms.cpp:629-639: batch b reads rows batch b-1
        # already updated); quality-gated in tests.  Walk models have no
        # standing halo — the flag is ignored there.
        self.halo_stale = bool(halo_stale) and self.model.attraction != "walk"
        self.lr = config.resolve_lr(self.model)
        self._dtype = jnp.dtype(config.dtype)

        self.layout = VertexShardLayout.build(
            graph,
            self.P,
            min_width=min_width,
            hub_width=hub_width,
            row_align=row_align,
        )
        lay = self.layout
        garr = {
            "send_idx": jnp.asarray(lay.send_idx),  # [P, P, H]
            "hot_send": jnp.asarray(lay.hot_send),  # [P, Hh]
            "inv_deg": jnp.asarray(
                1.0 / (lay.deg_loc.astype(np.float64) + 1.0), dtype=self._dtype
            ),  # [P, n_loc]
        }
        for bi, b in enumerate(lay.buckets):
            garr[f"nbr{bi}"] = jnp.asarray(b.nbr)  # [P, count, width]
            garr[f"deg{bi}"] = jnp.asarray(b.deg)  # [P, count]
            if b.owners is not None:
                garr[f"own{bi}"] = jnp.asarray(b.owners)
        if self.model.attraction == "walk":
            garr["gmap"] = jnp.asarray(lay.gmap)  # [P, table_len]
            garr["deg_all"] = jnp.asarray(lay.deg_loc)  # [P, n_loc]
            hub = lay.buckets[-1] if lay.buckets[-1].owners is not None else None
            first = None
            if hub is not None:
                # first virtual row per hub owner offset (owners' vrows are
                # consecutive per shard) — the walk engine's hub lookup
                first = np.zeros((self.P, max(hub.real_count, 1)), dtype=np.int32)
                for p in range(self.P):
                    u, idx = np.unique(hub.owners[p], return_index=True)
                    first[p, u] = idx.astype(np.int32)
                garr["first_vrow"] = jnp.asarray(first)
            # flat-pool walk tables (one gather per step instead of a
            # per-bucket where-chain, as in the sync engine): pool = every bucket rectangle concatenated,
            # base[p, lr] = flat offset of local row lr's slot 0.  Exact
            # for hubs (consecutive virtual rows linearize the CSR row).
            pool = np.concatenate(
                [b.nbr.reshape(self.P, -1) for b in lay.buckets], axis=1)
            base = np.zeros((self.P, lay.n_loc), dtype=np.int64)
            off = 0
            for b in lay.buckets:
                if b.owners is None:
                    rows = np.arange(b.count, dtype=np.int64)
                    base[:, b.start_local + rows] = off + rows * b.width
                else:
                    rc = max(b.real_count, 1)
                    cols = b.start_local + np.arange(rc, dtype=np.int64)
                    cols = np.minimum(cols, lay.n_loc - 1)
                    base[np.arange(self.P)[:, None], cols[None, :]] = (
                        off + first[:, :rc].astype(np.int64) * b.width)
                off += b.count * b.width
            garr["walk_pool"] = jnp.asarray(pool.astype(np.int32))
            garr["walk_base"] = jnp.asarray(base.astype(np.int32))
        if self.model.attraction == "walk":
            # Walk-target embedding fetch mode.  'ring' rotates the full
            # local table P-1 times: (P-1)·n_loc rows/iter/shard regardless
            # of need.  'a2a' fetches only the deduplicated needed rows via
            # a request/response all_to_all pair, provisioned at a STATIC
            # per-pair cap C (XLA shapes): counted on the bench graph, the
            # needed-rows volume is 0.43x the ring at P=8 and 0.15x at
            # P=32.  Slots that overflow
            # the cap are dropped from that iteration's attraction (the
            # cap carries `walk_fetch_slack` headroom over the preflight
            # worst, so overflow is a never-in-practice tail; the parity
            # tests assert a2a == ring exactly on real draws).
            if walk_fetch not in ("ring", "a2a", "auto"):
                raise ValueError(f"walk_fetch must be ring/a2a/auto, got {walk_fetch!r}")
            cap = walk_fetch_cap
            if walk_fetch != "ring" and self.P > 1:
                if cap is None:
                    cap = self._preflight_walk_cap(slack=walk_fetch_slack)
                if walk_fetch == "auto":
                    walk_fetch = "a2a" if cap < lay.n_loc else "ring"
            else:
                walk_fetch = "ring"
            self.walk_fetch = walk_fetch
            self.walk_cap = int(cap) if walk_fetch == "a2a" else 0
        self._gspecs = {k: P("vp") for k in garr}
        if self.model.attraction == "walk":
            # whole-graph maps every shard reads (replicated, not sharded)
            garr["shard_of"] = jnp.asarray(lay.shard_of)  # [n]
            garr["lrow_of"] = jnp.asarray(lay.lrow_of)  # [n]
            self._gspecs["shard_of"] = P()
            self._gspecs["lrow_of"] = P()
        # placed on the mesh once, so training calls do not re-send them
        self._garr = {
            k: jax.device_put(np.asarray(v),
                              NamedSharding(self.mesh, self._gspecs[k]))
            for k, v in garr.items()
        }

        from force2vec_tpu.train.trainer import make_train_dispatcher

        self.x_spec = P("vp", None)
        self._iteration = self._build_iteration_fn()
        train = self._build_train_fn()

        # walk-fetch overflow counter: device-side int32 total of a2a
        # cap-overflow drops across all trained iterations (0 for the exact
        # ring and the CSR models); read via ``walk_overflow_dropped()``.
        self._overflow_dev = jnp.int32(0)

        def jit_for(k):
            sharded = jax.shard_map(
                lambda g, x, key, off: train(g, x, key, k, off),
                mesh=self.mesh,
                in_specs=(self._gspecs, self.x_spec, P(), P()),
                out_specs=(self.x_spec, P()),
                check_vma=False,
            )
            jf = jax.jit(sharded)

            def run(g, x, key, off):
                xn, drops = jf(g, x, key, off)
                self._overflow_dev = self._overflow_dev + drops
                return xn

            return run

        self._train_jit = make_train_dispatcher(jit_for)

    def walk_overflow_dropped(self) -> int:
        """Total a2a walk-fetch slots dropped past the cap over every
        iteration trained so far (device counter; fetching syncs)."""
        return int(np.asarray(self._overflow_dev))

    def _preflight_walk_cap(self, iters: int = 4, slack: float = 1.5) -> int:
        """Host-side sizing of the a2a walk-fetch cap: run ``iters`` rounds
        of uniform-neighbor walks (the engine's semantics — slot uniform in
        [0, deg), deg-0 stays put) and take the worst per-(shard, peer)
        DEDUPLICATED remote-row need, padded by ``slack`` and rounded up to
        a sublane multiple.  The cap must hold for every iteration (static
        shapes), so worst — not mean — is the operative number."""
        lay, g = self.layout, self.graph
        wl = self.config.walk_length
        rng = np.random.default_rng(97)
        rowptr, colids = g.rowptr, g.colids
        deg = (rowptr[1:] - rowptr[:-1]).astype(np.int64)
        owner_v = lay.shard_of[lay.inv_perm]  # owner of original id v
        n = g.n
        worst = 0
        P_ = self.P
        for _ in range(iters):
            cur = np.arange(n, dtype=np.int64)
            tgts = []
            for _s in range(wl):
                d = deg[cur]
                slot = rng.integers(0, 1 << 31, size=n) % np.maximum(d, 1)
                nxt = colids[rowptr[cur] + np.minimum(slot, np.maximum(d - 1, 0))]
                cur = np.where(d > 0, nxt, cur)
                tgts.append(cur)
            tgt = np.stack(tgts, axis=1)  # [n, wl] original ids
            t_owner = owner_v[tgt]
            w_owner = np.broadcast_to(owner_v[:, None], tgt.shape)
            # one np.unique over (walker-owner, target)-encoded keys replaces
            # the former O(P²) python loop of per-pair uniques (minutes of
            # numpy at large n·P — ADVICE r3)
            rem = t_owner != w_owner
            enc = (
                (w_owner[rem].astype(np.int64) * P_ + t_owner[rem]) * n
                + tgt[rem]
            )
            pairs = np.unique(enc) // n  # one entry per unique (q,p,target)
            if pairs.size:
                counts = np.bincount(pairs, minlength=P_ * P_)
                worst = max(worst, int(counts.max()))
        cap = int(-(-int(worst * slack) // 8) * 8)
        return max(8, min(cap, lay.n_loc))

    # -- embedding layout ----------------------------------------------------

    def init_embedding(self, seed: int = 1) -> jnp.ndarray:
        key = jax.random.PRNGKey(seed)
        shape = (self.P * self.layout.n_loc, self.config.dim)
        if self.model.init == "uniform01":
            x = jax.random.uniform(key, shape, dtype=self._dtype)
        else:
            x = jax.random.uniform(key, shape, dtype=self._dtype, minval=-1.0, maxval=1.0)
        return jax.device_put(x, NamedSharding(self.mesh, self.x_spec))

    def pad_embedding(self, x: np.ndarray) -> jnp.ndarray:
        """Host [n, D] (original id order) → device [P·n_loc, D] sharded."""
        lay = self.layout
        x = np.asarray(x, dtype=self._dtype)
        out = np.zeros((self.P * lay.n_loc, self.config.dim), dtype=self._dtype)
        g = lay.inv_perm[np.arange(lay.n)]  # global degree-sorted row of id v
        out[lay.shard_of[g] * lay.n_loc + lay.lrow_of[g]] = x
        return jax.device_put(out, NamedSharding(self.mesh, self.x_spec))

    def unpad_embedding(self, x) -> np.ndarray:
        """Device [P·n_loc, D] sharded → host [n, D] original order."""
        lay = self.layout
        if jax.process_count() > 1:
            # shards on other processes are not addressable here; one
            # cross-process allgather assembles the global table
            from jax.experimental import multihost_utils

            x = multihost_utils.process_allgather(x, tiled=True)
        x = np.asarray(x)
        g = lay.inv_perm[np.arange(lay.n)]
        return x[lay.shard_of[g] * lay.n_loc + lay.lrow_of[g]]

    # -- the per-shard iteration ----------------------------------------------

    def _build_iteration_fn(self):
        lay, model, cfg = self.layout, self.model, self.config
        n_loc, H, Pn = lay.n_loc, lay.halo_width, lay.n_shards
        Hh = lay.hot_width
        ns, dim = cfg.ns, cfg.dim
        covered = sum(
            b.real_count if b.owners is None else 0 for b in lay.buckets
        )
        hub = lay.buckets[-1] if lay.buckets and lay.buckets[-1].owners is not None else None
        covered += hub.real_count if hub is not None else 0

        def force_sum(kind, xi, xj, dg, invd, step):
            return masked_force_sum(model, kind, xi, xj, dg, invd, step)

        def bucket_force(g, x_loc, xtab, bi, b, step):
            """Masked ELL force for one slab, gathering neighbors from
            ``xtab`` (= x_loc for halo-free slabs)."""
            nbr, dg_b = g[f"nbr{bi}"][0], g[f"deg{bi}"][0]
            xj = jnp.take(xtab, nbr.reshape(-1), axis=0).reshape(
                b.count, b.width, dim
            )
            if b.owners is None:
                xi = jax.lax.dynamic_slice(
                    x_loc, (b.start_local, 0), (b.count, dim)
                )
                invd = jax.lax.dynamic_slice(
                    g["inv_deg"][0], (b.start_local,), (b.count,)
                )
            else:
                own = g[f"own{bi}"][0]
                xi = jnp.take(x_loc, own + jnp.int32(b.start_local), axis=0)
                invd = jnp.take(g["inv_deg"][0], own + jnp.int32(b.start_local))
            part = force_sum("edge", xi, xj, dg_b, invd, step)
            if b.owners is not None:
                part = jax.ops.segment_sum(
                    part, g[f"own{bi}"][0], num_segments=b.real_count
                )
            return part

        wl = cfg.walk_length
        n_total = lay.n
        walk_fetch = getattr(self, "walk_fetch", "ring")
        C = getattr(self, "walk_cap", 0)

        def attraction_walk_a2a(g, x_loc, walks, step):
            """Needed-rows-only walk fetch: deduplicate this shard's remote
            walk targets per owner on device (sort + segmented unique-rank),
            all_to_all the ≤C local-row requests per peer, answer with one
            gather, all_to_all the rows back — (P-1)·C embedding rows on
            the wire instead of the ring's (P-1)·n_loc (0.43x at P=8,
            0.15x at P=32 on the bench graph).  Slots past the cap are dropped from this iteration's
            attraction — the cap is preflight-sized with slack so that is
            a never-in-practice tail, and parity vs the ring is asserted
            on real draws in tests."""
            rank = jax.lax.axis_index("vp") if Pn > 1 else 0
            invd = g["inv_deg"][0]
            t = walks.reshape(-1)  # [M] global ids or -1
            m_sz = t.shape[0]
            valid = t >= 0
            tc = jnp.clip(t, 0, n_total - 1)
            owner = jnp.take(g["shard_of"], tc)
            lr = jnp.take(g["lrow_of"], tc)
            is_local = owner == rank
            # group: remote slots by owner; local → Pn, invalid → Pn+1
            grp = jnp.where(valid, jnp.where(is_local, Pn, owner), Pn + 1)
            key = grp * jnp.int32(n_loc) + jnp.where(grp < Pn, lr, 0)
            order = jnp.argsort(key)
            ks = jnp.take(key, order)
            lrs = jnp.take(lr, order)
            os_ = ks // jnp.int32(n_loc)
            uniq = jnp.concatenate(
                [jnp.ones((1,), jnp.int32), (ks[1:] != ks[:-1]).astype(jnp.int32)]
            )
            uidx = jnp.cumsum(uniq) - 1  # unique-key index (shared by dups)
            ucount = jax.ops.segment_sum(uniq, os_, num_segments=Pn + 2)
            ubase = jnp.cumsum(ucount) - ucount
            upos = uidx - jnp.take(ubase, os_)  # rank within owner group
            # request buffer [Pn, C]: the c-th unique remote row per owner
            sel = (uniq > 0) & (os_ < Pn) & (upos < C)
            slot = jnp.where(sel, os_ * C + jnp.minimum(upos, C - 1), Pn * C)
            req = (
                jnp.zeros((Pn * C + 1,), jnp.int32)
                .at[slot].set(jnp.where(sel, lrs, 0))[: Pn * C]
                .reshape(Pn, C)
            )
            if Pn > 1:
                got = jax.lax.all_to_all(req, "vp", split_axis=0, concat_axis=0)
            else:
                got = req
            resp = jnp.take(x_loc, got.reshape(-1), axis=0).reshape(Pn, C, dim)
            if Pn > 1:
                resp = jax.lax.all_to_all(resp, "vp", split_axis=0, concat_axis=0)
            # per-slot fetch: invert the sort to map slots → (grp, upos)
            upos_slot = jnp.zeros((m_sz,), jnp.int32).at[order].set(upos)
            remote_ok = (grp < Pn) & (upos_slot < C)
            resp_flat = resp.reshape(Pn * C, dim)
            fetch = jnp.where(
                remote_ok, grp * C + jnp.minimum(upos_slot, C - 1), 0
            )
            xr = jnp.take(resp_flat, fetch, axis=0)
            xl = jnp.take(x_loc, lr, axis=0)
            xj = jnp.where(is_local[:, None], xl, xr).reshape(n_loc, wl, dim)
            ok = (valid & (is_local | remote_ok)).reshape(n_loc, wl)
            # overflow observability (ADVICE r3): slots whose per-owner
            # unique rank exceeded the static cap C are dropped from this
            # iteration's attraction — count them ON DEVICE so a
            # distribution shift cannot degrade quality invisibly.  The
            # count is psummed to a replicated scalar and surfaced via
            # ``last_walk_overflow`` / asserted 0 in tests.
            dropped = jnp.sum(
                ((grp < Pn) & (upos_slot >= C)).astype(jnp.int32)
            )
            if Pn > 1:
                dropped = jax.lax.psum(dropped, "vp")
            f = model.edge_force(
                x_loc[:, None, :], xj, invd[:, None, None], step,
                mask=ok[:, :, None],
            )
            return jnp.sum(f, axis=1), dropped

        def attraction_walk(g, x_loc, walks, step):
            """Sigmoid force against the walk targets (global ids), fetched
            by rotating ``x_loc`` around the vp ring (P-1 ppermutes, each
            overlappable with the masked per-round force evaluation) — the
            framework's ring-attention analog: the KV rotation is an
            embedding-chunk rotation (SURVEY.md §5).  With
            ``walk_fetch='a2a'`` the needed-rows-only exchange of
            :func:`attraction_walk_a2a` replaces the ring.  Returns
            ``(acc, dropped)`` — dropped is the replicated count of
            cap-overflow slots (always 0 for the exact ring)."""
            if walk_fetch == "a2a":
                return attraction_walk_a2a(g, x_loc, walks, step)
            ownerW = jnp.take(g["shard_of"], jnp.clip(walks, 0, n_total - 1))
            lrW = jnp.take(g["lrow_of"], jnp.clip(walks, 0, n_total - 1))
            validW = walks >= 0
            invd = g["inv_deg"][0]
            rank = jax.lax.axis_index("vp") if Pn > 1 else 0
            acc = jnp.zeros((n_loc, dim), dtype=x_loc.dtype)
            chunk = x_loc
            for r in range(Pn):
                owner_r = (rank - r) % Pn
                xj = jnp.take(chunk, lrW.reshape(-1), axis=0).reshape(
                    n_loc, wl, dim
                )
                m = (ownerW == owner_r) & validW
                f = model.edge_force(
                    x_loc[:, None, :], xj, invd[:, None, None], step,
                    mask=m[:, :, None],
                )
                acc = acc + jnp.sum(f, axis=1)
                if r < Pn - 1:
                    chunk = jax.lax.ppermute(
                        chunk, "vp", [(i, (i + 1) % Pn) for i in range(Pn)]
                    )
            return acc, jnp.int32(0)

        def exchange(g, x_loc):
            """Issue both exchange tiers; returns (halo [P,H,D], hot [...])."""
            send = jnp.take(x_loc, g["send_idx"][0], axis=0)  # [P, H, D]
            hot_mine = jnp.take(x_loc, g["hot_send"][0], axis=0)  # [Hh, D]
            if Pn > 1:
                halo = jax.lax.all_to_all(
                    send, "vp", split_axis=0, concat_axis=0
                )
                hot = jax.lax.all_gather(hot_mine, "vp", axis=0, tiled=True)
            else:
                halo = send
                hot = hot_mine
            return halo, hot

        self._exchange = exchange

        def iteration(g, x_loc, pool_rows, choice, walks, step, prev=None):
            """One epoch-synchronous step on this shard.

            Overlap schedule: the hot all_gather and the cold all_to_all
            are issued first; the halo-FREE slabs (phase='free', reading
            only ``x_loc``) and the repulsion term have no data dependency
            on them, so XLA's latency-hiding scheduler computes them while
            the exchange flies; the halo-DEPENDENT slabs read
            ``[x_loc | hot | halo]`` and schedule after it lands.

            ``prev`` (iteration-pipelined mode): the buffers exchanged at
            the PREVIOUS iteration; this iteration consumes them (one
            iteration stale) and returns the freshly issued pair — the
            in-flight collective then has NO consumer anywhere in this
            iteration, so nothing in the program blocks on it.

            For the walk model (rwalk), attraction is the ring schedule of
            :func:`attraction_walk` over injected/driven walk targets.
            """
            step = jnp.asarray(step, dtype=x_loc.dtype)
            if choice is None:
                s = jnp.broadcast_to(pool_rows[None], (n_loc, ns, dim))
            else:
                s = jnp.take(pool_rows, choice.reshape(-1), axis=0).reshape(
                    n_loc, ns, dim
                )
            full = jnp.full((n_loc,), ns, dtype=jnp.int32)
            invd0 = jnp.zeros((n_loc,), dtype=x_loc.dtype)

            drops = jnp.int32(0)
            nxt = None
            if model.attraction == "walk":
                rep = force_sum("sample", x_loc, s, full, invd0, step)
                aw, drops = attraction_walk(g, x_loc, walks, step)
                upd = aw + rep
            else:
                # 1. issue the exchange (both tiers); consume the stale
                # pair when pipelined
                cur = exchange(g, x_loc)
                if prev is None:
                    halo, hot = cur
                else:
                    halo, hot = prev
                    nxt = cur

                # 2. halo-free slabs + repulsion — overlap with the exchange
                parts = {}
                for bi, b in enumerate(lay.buckets):
                    if b.phase == "free":
                        parts[bi] = bucket_force(g, x_loc, x_loc, bi, b, step)
                rep = force_sum("sample", x_loc, s, full, invd0, step)

                # 3. halo-dependent slabs read the assembled table
                xtab = jnp.concatenate(
                    [x_loc, hot.reshape(Pn * Hh, dim), halo.reshape(Pn * H, dim)],
                    axis=0,
                )
                for bi, b in enumerate(lay.buckets):
                    if b.phase != "free":
                        parts[bi] = bucket_force(g, x_loc, xtab, bi, b, step)

                ordered = [parts[bi] for bi in range(len(lay.buckets))]
                if n_loc > covered:
                    ordered.append(
                        jnp.zeros((n_loc - covered, dim), dtype=x_loc.dtype)
                    )
                upd = jnp.concatenate(ordered, axis=0) + rep

            # 4. apply — owner-local, NO collective: the energy norm is
            # per-vertex (factor_i = STEP/√‖upd_i‖², algorithms.cpp:224-239)
            if model.update == "energy":
                fnorm = jnp.sum(upd * upd, axis=-1, keepdims=True)
                safe = jnp.where(fnorm > 0, fnorm, 1.0)
                factor = jnp.where(fnorm > 0, step / jnp.sqrt(safe), 0.0)
                xn = x_loc + factor * upd
            else:
                xn = x_loc + upd
            if prev is None:
                return xn, drops
            return xn, drops, nxt

        return iteration

    def _build_walk_fn(self):
        """Distributed L-step uniform walk engine.

        The frontier (each local walker's current GLOBAL row) is
        all_gathered as ids (4 bytes/walker — cheap); every shard answers
        the queries for rows it owns by one lookup in its own ELL tables,
        translated back to global ids via ``gmap``; one psum merges the
        answers.  Per step: one [P·n_loc] int all_gather + one psum — no
        embedding rows move (those are fetched later by the ring in
        attraction_walk).  Matches the reference's per-iteration 5-step
        walks (sample/algorithms.cpp:1097-1118) in vectorized form.
        """
        lay, cfg = self.layout, self.config
        n_loc, Pn, n = lay.n_loc, lay.n_shards, lay.n
        wl = cfg.walk_length

        def neighbor_of_local(g, lr, slot):
            """remapped-neighbor id of (local row lr, slot) on this shard:
            one flat-pool gather (see walk_pool/walk_base in __init__)."""
            pos = jnp.take(g["walk_base"][0],
                           jnp.clip(lr, 0, n_loc - 1)) + slot
            pool = g["walk_pool"][0]
            return jnp.take(pool, jnp.clip(pos, 0, pool.shape[0] - 1))

        def walks(g, key):
            rank = jax.lax.axis_index("vp") if Pn > 1 else 0
            gmap_loc = g["gmap"][0][:n_loc]  # [n_loc] global id or -1
            f = jnp.clip(gmap_loc, 0, n - 1)
            valid = gmap_loc >= 0
            targets = []
            for t in range(wl):
                rand = jax.random.randint(
                    jax.random.fold_in(key, t), (Pn * n_loc,), 0,
                    jnp.iinfo(jnp.int32).max, dtype=jnp.int32,
                )
                if Pn > 1:
                    F = jax.lax.all_gather(f, "vp", axis=0, tiled=True)
                else:
                    F = f
                owner = jnp.take(g["shard_of"], F)
                mine = owner == rank
                lr = jnp.take(g["lrow_of"], F)
                d = jnp.take(g["deg_all"][0], jnp.clip(lr, 0, n_loc - 1))
                slot = rand % jnp.maximum(d, 1)
                nxt_rem = neighbor_of_local(g, lr, slot)
                nxt_g = jnp.take(g["gmap"][0], nxt_rem)
                ans = jnp.where(d > 0, nxt_g, F)  # deg-0 rows stay put
                ans = jnp.where(mine, ans, 0)
                if Pn > 1:
                    ans = jax.lax.psum(ans, "vp")
                f = jax.lax.dynamic_slice(ans, (rank * n_loc,), (n_loc,))
                targets.append(jnp.where(valid, f, -1))
            return jnp.stack(targets, axis=1)  # [n_loc, wl] global ids / -1

        return walks

    def _build_pool_fn(self):
        """(g, x_loc, pool_g) -> [S, D] replicated rows of global ids
        ``pool_g`` — a masked gather + one psum over ``vp``."""
        lay = self.layout
        shard_of = jnp.asarray(lay.shard_of)
        lrow_of = jnp.asarray(lay.lrow_of)
        Pn = lay.n_shards

        def pool_rows(x_loc, pool_g):
            rank = jax.lax.axis_index("vp") if Pn > 1 else 0
            owner = jnp.take(shard_of, pool_g)
            lr = jnp.take(lrow_of, pool_g)
            mine = (owner == rank).astype(x_loc.dtype)[:, None]
            rows = jnp.take(x_loc, lr, axis=0) * mine
            if Pn > 1:
                rows = jax.lax.psum(rows, "vp")
            return rows

        return pool_rows

    def _build_train_fn(self):
        lay, model, cfg = self.layout, self.model, self.config
        iteration = self._iteration
        pool_fn = self._build_pool_fn()
        walk_fn = self._build_walk_fn() if model.attraction == "walk" else None
        lr = self.lr
        n_loc, Pn = lay.n_loc, lay.n_shards
        S = cfg.ns if self.sampling == "shared" else self.neg_pool

        def draw(g, key, it):
            kit = jax.random.fold_in(key, it)
            # pool ids: same on every rank (key independent of rank)
            pool_g = jax.random.randint(
                jax.random.fold_in(kit, 0), (S,), 0, max(lay.n - 1, 1), jnp.int32
            )
            choice = None
            if self.sampling == "pool":
                rank = jax.lax.axis_index("vp") if Pn > 1 else 0
                ckey = jax.random.fold_in(jax.random.fold_in(kit, 1), rank)
                choice = jax.random.randint(
                    ckey, (n_loc, cfg.ns), 0, S, dtype=jnp.int32
                )
            walks = None
            if walk_fn is not None:
                walks = walk_fn(g, jax.random.fold_in(kit, 2))
            return pool_g, choice, walks

        def step_of(it, dtype):
            if model.lr_schedule == "decay999":
                return lr * jnp.power(jnp.float32(0.999), it).astype(dtype)
            return jnp.asarray(lr, dtype=dtype)

        if self.halo_stale:
            # iteration-pipelined: the exchange issued at iteration i is
            # consumed at i+1 — prime the carry with x0's exchange so
            # iteration 0 reads exact buffers
            def train(g, x_loc, key, num_iters, iter_offset):
                def body(t, carry):
                    xc, drop_acc, prev = carry
                    it = iter_offset + t
                    pool_g, choice, walks = draw(g, key, it)
                    rows = pool_fn(xc, pool_g)
                    xn, drops, nxt = iteration(
                        g, xc, rows, choice, walks,
                        step_of(it, xc.dtype), prev=prev)
                    return xn, drop_acc + drops, nxt

                prev0 = self._exchange(g, x_loc)
                xn, drop_acc, _ = jax.lax.fori_loop(
                    0, num_iters, body, (x_loc, jnp.int32(0), prev0)
                )
                return xn, drop_acc

            return train

        def train(g, x_loc, key, num_iters, iter_offset):
            def body(t, carry):
                xc, drop_acc = carry
                it = iter_offset + t
                pool_g, choice, walks = draw(g, key, it)
                rows = pool_fn(xc, pool_g)
                xn, drops = iteration(
                    g, xc, rows, choice, walks, step_of(it, xc.dtype))
                return xn, drop_acc + drops

            return jax.lax.fori_loop(
                0, num_iters, body, (x_loc, jnp.int32(0))
            )

        return train

    # -- public API ------------------------------------------------------------

    def run_iteration(self, x, pool_ids, choice=None, step=None, walks=None):
        """One iteration with injected global-relabeled pool ids [S] (and
        optional [P·n_loc, ns] pool choices) — the parity-test entry point.

        ``walks``: for the rwalk model, [n, L] walk targets indexed by
        GLOBAL degree-sorted row (the same array the sync schedule takes),
        values being global rows; each shard picks out its walkers' rows.
        """
        if step is None:
            step = self.lr
        # one compiled program per argument structure, built on first use
        cache = self.__dict__.setdefault("_run_iteration_jit", {})
        key = (choice is None, walks is None)
        if key not in cache:
            pool_fn = self._build_pool_fn()
            iteration = self._iteration
            n, n_loc = self.layout.n, self.layout.n_loc

            def one(g, x_loc, pool_g, ch, wg, s):
                rows = pool_fn(x_loc, pool_g)
                w_loc = None
                if wg is not None:
                    gmap_loc = g["gmap"][0][:n_loc]
                    wl_rows = jnp.take(wg, jnp.clip(gmap_loc, 0, n - 1), axis=0)
                    w_loc = jnp.where((gmap_loc >= 0)[:, None], wl_rows, -1)
                return iteration(g, x_loc, rows, ch, w_loc, s)

            ch_spec = P() if choice is None else self.x_spec
            cache[key] = jax.jit(jax.shard_map(
                one,
                mesh=self.mesh,
                in_specs=(self._gspecs, self.x_spec, P(), ch_spec, P(), P()),
                out_specs=(self.x_spec, P()),
                check_vma=False,
            ))
        sharded = cache[key]
        ch = None if choice is None else jnp.asarray(choice, dtype=jnp.int32)
        w = None if walks is None else jnp.asarray(walks, dtype=jnp.int32)
        xn, drops = sharded(
            self._garr,
            jnp.asarray(x),
            jnp.asarray(pool_ids, dtype=jnp.int32),
            ch,
            w,
            jnp.asarray(step, dtype=self._dtype),
        )
        self._overflow_dev = self._overflow_dev + drops
        return xn

    def comm_stats(self) -> dict:
        """Per-iteration communication accounting, per shard (rows are
        [D]-wide embedding rows unless stated).  Makes the exchange volume
        visible in logs/artifacts instead of buried in the layout
        (the rwalk ring ships the full local table P-1 times — that cost
        must be a number, not a surprise)."""
        lay, cfg = self.layout, self.config
        Pn, dim = lay.n_shards, cfg.dim
        itemsize = jnp.dtype(self._dtype).itemsize
        rows = {
            # cold tier: all_to_all sends (P-1) of the P H-row slabs
            "cold_alltoall_rows_sent": (Pn - 1) * lay.halo_width,
            # hot tier: contribute Hh rows, receive (P-1)·Hh
            "hot_allgather_rows_recv": (Pn - 1) * lay.hot_width,
            # negative pool: one [S, D] psum (ring ~ 2·S rows on the wire)
            "pool_psum_rows": (
                cfg.ns if self.sampling == "shared" else self.neg_pool
            ),
        }
        if self.model.attraction == "walk":
            if getattr(self, "walk_fetch", "ring") == "a2a":
                # needed-rows fetch: (P-1)·C response rows + C-row id
                # requests per peer (the id words are 4 B each)
                rows["rwalk_a2a_rows_sent"] = (Pn - 1) * self.walk_cap
                rows["rwalk_id_words_sent"] = (
                    (Pn - 1) * self.walk_cap
                    + 2 * cfg.walk_length * (Pn - 1) * lay.n_loc
                )
            else:
                # ring fetch rotates the full local table P-1 times ...
                rows["rwalk_ring_rows_sent"] = (Pn - 1) * lay.n_loc
                # ... plus wl frontier all_gathers ([P·n_loc] int32 ids)
                # and wl psums of the answers (ids, not embedding rows)
                rows["rwalk_id_words_sent"] = (
                    2 * cfg.walk_length * (Pn - 1) * lay.n_loc
                )
        # id words ("*_id_words_*") are 4 B each, NOT [D]-wide embedding
        # rows — keep them out of the row sum (they are charged at 4 B in
        # bytes_per_iter_per_shard below)
        emb_rows = sum(
            v for k, v in rows.items()
            if k.endswith(("_rows_sent", "_rows_recv", "_rows"))
        )
        out = {
            **rows,
            "bytes_per_iter_per_shard": emb_rows * dim * itemsize
            + rows.get("rwalk_id_words_sent", 0) * 4,
            "layout": dict(lay.stats),
        }
        return out

    def train(
        self,
        iters: int = 1200,
        seed: int = 1,
        x0: Optional[np.ndarray] = None,
        verbose: bool = False,
    ) -> np.ndarray:
        if verbose:
            cs = self.comm_stats()
            print(
                f"vp={self.P} comm/iter/shard: "
                f"{cs['bytes_per_iter_per_shard']/1e6:.2f} MB "
                f"(cold {cs['cold_alltoall_rows_sent']} rows, "
                f"hot {cs['hot_allgather_rows_recv']} rows"
                + (
                    f", rwalk ring {cs['rwalk_ring_rows_sent']} rows"
                    if "rwalk_ring_rows_sent" in cs
                    else ""
                )
                + ")",
                flush=True,
            )
        x = self.pad_embedding(x0) if x0 is not None else self.init_embedding(seed)
        key = jax.random.PRNGKey(seed)
        x = self._train_jit(self._garr, x, key, iters, 0)
        return self.unpad_embedding(x)
