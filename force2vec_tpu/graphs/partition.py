"""Vertex partition + halo-exchange layout for the sharded embedding table.

The reference is single-address-space OpenMP: every thread reads any row of
``nCoordinates`` through the cache hierarchy (SURVEY.md §2.5 / §5 — there is
no distributed backend to translate).  This module is the from-scratch
answer for graphs whose embedding table outgrows one chip's HBM: a 1-D
vertex partition of X over a ``vp`` mesh axis, with remote neighbor rows
("the halo") delivered once per iteration by static-shape collectives.

Exchange design (v2 — popularity-tiered, overlap-ready):

* **Hot tier**: remote rows needed by ≥ ``hot_min`` shards ship ONCE via a
  tiled ``all_gather`` instead of appearing in (up to) P-1 pairwise halo
  lists.  On power-law graphs the high-degree rows are in almost every
  shard's need list, so this cuts both the total exchanged rows and the
  worst-pair padding (the previous uniform-width all_to_all paid the worst
  (src, dst) pair's width on every pair).
* **Cold tier**: the remaining rows (needed by few shards) go through the
  pairwise ``all_to_all`` with width = the (now much smaller) worst pair.
* **Free/dep bucket split**: each degree bucket is laid out as a halo-free
  sub-bucket (rows whose neighbors are ALL shard-local) followed by a
  halo-dependent sub-bucket.  The free sub-buckets read only ``x_loc``, so
  XLA's latency-hiding scheduler runs them while the collectives fly; the
  dep sub-buckets read the ``[x_loc | hot | halo]`` table and schedule
  after the exchange completes — the force-directed analog of overlapping
  a ring-attention KV rotation with local attention (SURVEY.md §5).

Layout construction (host side, all numpy):

* vertices are relabeled by ascending degree exactly like
  :class:`~force2vec_tpu.graphs.csr.SyncLayout` (same ``perm``), grouped
  into the same power-of-two ELL degree buckets, and dealt round-robin to
  the P shards for balance;
* within each bucket, every shard places its halo-free rows first, then its
  halo-dependent rows; both regions are padded to the max count across
  shards so all per-shard tables stack into uniform ``[P, ...]`` arrays and
  per-bucket force results concatenate into the local update with no
  scatter;
* rows with degree > ``hub_width`` split into virtual rows on the owner's
  shard (all halo-dependent); their partials segment-sum into owner rows;
* neighbor ids are pre-remapped into each shard's
  ``[local | hot | halo]`` index space;
* ``send_idx[q, p]`` lists the q-local cold rows shard p needs;
  ``hot_send[q]`` lists the q-local rows of the hot tier.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from force2vec_tpu.graphs.csr import Graph, _round_up


@dataclasses.dataclass
class ShardBucket:
    """One (degree bucket × phase) slab of the vertex-sharded layout.  All
    arrays carry a leading shard axis P.  Non-hub buckets cover local rows
    ``[start_local, start_local + count)`` on every shard; the hub bucket's
    ``owners`` are local-row offsets *within* the hub range."""

    width: int
    start_local: int  # first local row of this slab (same on all shards)
    count: int  # rows per shard (virtual rows for the hub bucket)
    real_count: int  # local rows this slab COVERS in the update concat:
    # the padded per-shard row count (non-hub: == count; hub: the padded
    # count of real owner rows, which the hub segment-sum reduces into)
    nbr: np.ndarray  # [P, count, width] int32 indices into [local|hot|halo]
    deg: np.ndarray  # [P, count] int32 valid neighbors per row
    owners: np.ndarray | None = None  # [P, count] int32 offsets into hub range
    phase: str = "dep"  # 'free': reads only x_loc; 'dep': needs the exchange


@dataclasses.dataclass
class VertexShardLayout:
    """Static popularity-tiered halo-exchange layout over P vertex shards."""

    n: int
    n_shards: int
    n_loc: int  # local embedding rows per shard (padding rows included)
    halo_width: int  # H — cold rows exchanged per (src, dst) shard pair
    hot_width: int  # Hh — hot rows contributed per shard to the all_gather
    perm: np.ndarray  # [n] original id of degree-sorted global row g
    inv_perm: np.ndarray  # [n] degree-sorted global row of original id
    shard_of: np.ndarray  # [n] owning shard of global row g
    lrow_of: np.ndarray  # [n] local row of global row g on its shard
    deg_loc: np.ndarray  # [P, n_loc] int32 degree per local row (0 = padding)
    buckets: list  # list[ShardBucket]; free slabs carry phase='free'
    send_idx: np.ndarray  # [P, P, H] int32 — send_idx[q, p] = q-local rows for p
    hot_send: np.ndarray  # [P, Hh] int32 — q-local rows in the hot tier
    padded_edges: int  # Σ P·count·width — gather volume per iteration
    gmap: np.ndarray  # [P, n_loc + P·Hh + P·H] int32 global id per slot (-1 pad)
    stats: dict  # exchange metrics (vs the uniform worst-pair v1 design)

    @staticmethod
    def build(
        graph: Graph,
        n_shards: int,
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        hot_min: int = 0,
        deal: str = "auto",
    ) -> "VertexShardLayout":
        """``hot_min``: a remote row needed by ≥ hot_min shards rides the
        all_gather tier; 0 (default) searches every threshold and picks the
        one minimizing rows received per shard.  ``hot_min > P`` disables
        the hot tier (pure pairwise).

        ``deal``: how each degree bucket's rows spread over shards.
        'block' gives shard p the p-th contiguous ORIGINAL-ID chunk of the
        bucket — original ids usually encode crawl/BFS locality, so
        neighbors co-locate and the halo shrinks on graphs with community
        structure (measured 2.2x fewer exchanged rows on an 8-community
        SBM vs 'rr').  'rr' deals round-robin in degree order
        (locality-free baseline).  'auto' (default) measures the worst
        (src, dst) pair width under both and keeps the cheaper — on
        structureless graphs (uniform-random endpoints) 'rr' wins slightly,
        on anything with locality 'block' wins big.  Every deal gives each
        shard exactly the same per-bucket row counts."""
        P = int(n_shards)
        n = graph.n
        deg_orig = graph.degrees.astype(np.int64)
        perm = np.argsort(deg_orig, kind="stable").astype(np.int32)
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(n, dtype=np.int32)
        deg_sorted = deg_orig[perm]

        widths = []
        w = min_width
        while w < hub_width:
            widths.append(w)
            w *= 2
        widths.append(hub_width)

        # --- global bucket ranges and the shard deal -------------------------
        ranges = []  # (width, i, j)
        i = 0
        for w in widths:
            j = int(np.searchsorted(deg_sorted, w, side="right"))
            if j > i:
                ranges.append((w, i, j))
                i = j
        hub_i = i  # rows [hub_i, n) have degree > hub_width

        def deal_shards(i0: int, j0: int, mode: str) -> np.ndarray:
            m = j0 - i0
            if mode == "rr":
                return (np.arange(m) % P).astype(np.int32)
            # block deal: balanced contiguous chunks in ORIGINAL-id order
            # (k-th of m rows -> shard k*P//m keeps counts within 1)
            by_id = np.argsort(perm[i0:j0], kind="stable")
            s = np.empty(m, dtype=np.int32)
            s[by_id] = (np.arange(m, dtype=np.int64) * P // m).astype(np.int32)
            return s

        def make_shard_of(mode: str) -> np.ndarray:
            sof = np.zeros(n, dtype=np.int32)
            for w, i0, j0 in ranges:
                sof[i0:j0] = deal_shards(i0, j0, mode)
            if hub_i < n:
                sof[hub_i:] = deal_shards(hub_i, n, mode)
            return sof

        col_g = inv_perm[graph.colids]  # every edge's target, global row id
        src_g = inv_perm[
            np.repeat(np.arange(n, dtype=np.int64), graph.degrees.astype(np.int64))
        ]

        if deal == "auto":
            # pick the deal with the smaller worst-(src,dst)-pair halo width
            def pair_cost(sof):
                rem = sof[col_g] != sof[src_g]
                rc = col_g[rem]
                rh = sof[src_g[rem]]
                ho = np.argsort(rh, kind="stable")
                b = np.searchsorted(rh[ho], np.arange(P + 1))
                rc = rc[ho]
                pm = 1
                for p in range(P):
                    u = np.unique(rc[b[p] : b[p + 1]])
                    if len(u):
                        pm = max(pm, int(np.bincount(sof[u], minlength=P).max()))
                return pm

            cand = {m: make_shard_of(m) for m in ("block", "rr")}
            costs = {m: pair_cost(s) for m, s in cand.items()}
            deal = min(costs, key=costs.get)
            shard_of = cand[deal]
        else:
            shard_of = make_shard_of(deal)

        # --- who needs whom: per-shard remote need lists --------------------
        edge_home = shard_of[src_g]
        remote = shard_of[col_g] != edge_home
        rcol = col_g[remote]
        rhome = edge_home[remote]
        horder = np.argsort(rhome, kind="stable")
        rcol_s = rcol[horder]
        bounds = np.searchsorted(rhome[horder], np.arange(P + 1))
        need = [np.unique(rcol_s[bounds[p] : bounds[p + 1]]) for p in range(P)]

        # popularity: how many shards need each global row remotely
        popularity = np.zeros(n, dtype=np.int32)
        for p in range(P):
            popularity[need[p]] += 1

        if hot_min <= 0:
            # Search every threshold t for the one minimizing rows RECEIVED
            # per shard: P·H(t) (cold pairwise, worst-pair padded) +
            # P·Hh(t) (hot all_gather, per-owner padded).
            # C[p, q, v] = #rows shard p needs from shard q with popularity v
            C = np.zeros((P, P, P + 2), dtype=np.int64)
            for p in range(P):
                u = need[p]
                np.add.at(C[p], (shard_of[u], popularity[u]), 1)
            Ccold = np.cumsum(C, axis=2)  # cold count at threshold t = Ccold[..., t-1]
            # Hq[q, v] = #rows owned by q with popularity v (among needed rows)
            needed_rows = np.flatnonzero(popularity > 0)
            Hq = np.zeros((P, P + 2), dtype=np.int64)
            np.add.at(Hq, (shard_of[needed_rows], popularity[needed_rows]), 1)
            Hhot_tail = Hq[:, ::-1].cumsum(axis=1)[:, ::-1]  # #rows with pop >= v
            best_cost, best_t = None, P + 1
            for t in range(2, P + 2):
                h_t = _round_up(max(1, int(Ccold[:, :, t - 1].max())), 8)
                hh_t = _round_up(max(1, int(Hhot_tail[:, t].max())), 8)
                cost = P * h_t + P * hh_t
                if best_cost is None or cost < best_cost:
                    best_cost, best_t = cost, t
            hot_min = best_t

        hot_mask = popularity >= hot_min
        hot_rows = np.flatnonzero(hot_mask)  # global rows in the hot tier

        # v1-equivalent metric (uniform worst-pair all_to_all over ALL needs)
        pair_max_v1 = 1
        total_need = 0
        for p in range(P):
            q_of = shard_of[need[p]]
            total_need += len(q_of)
            if len(q_of):
                pair_max_v1 = max(pair_max_v1, int(np.bincount(q_of, minlength=P).max()))
        H_v1 = _round_up(pair_max_v1, 8)

        # cold tier: needs minus hot rows, ordered (owner shard, lrow later)
        cold_need = [u[~hot_mask[u]] for u in need]
        pair_max = 1
        cold_total = 0
        for p in range(P):
            q_of = shard_of[cold_need[p]]
            cold_total += len(q_of)
            if len(q_of):
                pair_max = max(pair_max, int(np.bincount(q_of, minlength=P).max()))
        H = _round_up(pair_max, 8)

        # hot tier slots: hot rows sorted by (owner shard, global row); each
        # shard contributes its hot rows padded to the max per-shard count.
        hot_by_shard = [hot_rows[shard_of[hot_rows] == q] for q in range(P)]
        Hh = _round_up(max([1] + [len(h) for h in hot_by_shard]), 8)
        hot_slot = np.full(n, -1, dtype=np.int64)  # g -> slot in hot buffer
        hot_send = np.zeros((P, Hh), dtype=np.int32)
        for q in range(P):
            h = hot_by_shard[q]
            hot_slot[h] = q * Hh + np.arange(len(h))

        # --- free/dep classification per global row -------------------------
        # a row is FREE iff every neighbor lives on its own shard
        edge_free = shard_of[col_g] == edge_home
        row_free = np.zeros(n, dtype=bool)
        # all(edge_free) per source row, in global-row order
        ends = np.cumsum(np.bincount(src_g, minlength=n))
        starts_e = ends - np.bincount(src_g, minlength=n)
        # reduceat over edges sorted by src_g
        eorder = np.argsort(src_g, kind="stable")
        ef = edge_free[eorder]
        counts = ends - starts_e
        has_edges = counts > 0
        # min of ef per segment == all free
        csum = np.concatenate([[0], np.cumsum(ef)])
        seg_sum = csum[ends] - csum[starts_e]
        row_free[has_edges] = seg_sum[has_edges] == counts[has_edges]
        row_free[~has_edges] = True  # isolated rows are trivially free

        # --- per-shard row placement: [free | dep] per bucket, uniform pad --
        lrow_of = np.zeros(n, dtype=np.int32)
        slabs = []  # (width, start_local, count, phase, rows_g_per_shard)
        start_local = 0
        for w, i0, j0 in ranges:
            for phase, sel in (("free", True), ("dep", False)):
                rows_ps = []
                for p in range(P):
                    rows_g = np.arange(i0, j0)[shard_of[i0:j0] == p]
                    rows_g = rows_g[row_free[rows_g] == sel]
                    rows_ps.append(rows_g)
                cmax = _round_up(max(len(r) for r in rows_ps), row_align)
                if max(len(r) for r in rows_ps) == 0:
                    continue
                for p in range(P):
                    lrow_of[rows_ps[p]] = start_local + np.arange(len(rows_ps[p]))
                slabs.append((w, start_local, cmax, phase, rows_ps))
                start_local += cmax
        hub_start_local = start_local
        hub_rows_ps = []
        hub_cps = 0
        if hub_i < n:
            for p in range(P):
                rows_g = np.arange(hub_i, n)[shard_of[hub_i:] == p]
                hub_rows_ps.append(rows_g)
                lrow_of[rows_g] = hub_start_local + np.arange(len(rows_g))
            hub_cps = _round_up(max(len(r) for r in hub_rows_ps), row_align)
            start_local += hub_cps
        n_loc = max(_round_up(start_local, row_align), row_align)

        deg_loc = np.zeros((P, n_loc), dtype=np.int32)
        deg_loc[shard_of, lrow_of] = deg_sorted.astype(np.int32)

        # --- send lists ------------------------------------------------------
        send_idx = np.zeros((P, P, H), dtype=np.int32)
        cold_slot = {}  # p -> (rows u, slots) for the remap fill
        for p in range(P):
            u = cold_need[p]
            order = np.lexsort((lrow_of[u], shard_of[u]))
            u = u[order]
            qs = shard_of[u]
            t = np.arange(len(u)) - np.searchsorted(qs, qs, side="left")
            send_idx[qs, p, t] = lrow_of[u]
            cold_slot[p] = (u, qs.astype(np.int64) * H + t)
        for q in range(P):
            h = hot_by_shard[q]
            hot_send[q, : len(h)] = lrow_of[h]

        # --- ELL fill in the [local | hot | halo] index space ----------------
        rowptr = graph.rowptr
        remap1 = np.zeros(n, dtype=np.int64)
        hot_base = n_loc
        halo_base = n_loc + P * Hh

        def fill(rows_g: np.ndarray, width: int, out_nbr, out_deg):
            lens = deg_sorted[rows_g].astype(np.int64)
            total = int(lens.sum())
            out_deg[: len(rows_g)] = lens.astype(np.int32)
            if total:
                row_of = np.repeat(np.arange(len(rows_g)), lens)
                within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
                flat = rowptr[perm[rows_g]][row_of] + within
                out_nbr[row_of, within] = remap1[inv_perm[graph.colids[flat]]]

        buckets = []
        padded_edges = 0
        for w, sl, cmax, phase, rows_ps in slabs:
            buckets.append(
                ShardBucket(
                    width=w,
                    start_local=sl,
                    count=cmax,
                    real_count=cmax,
                    nbr=np.zeros((P, cmax, w), dtype=np.int32),
                    deg=np.zeros((P, cmax), dtype=np.int32),
                    phase=phase,
                )
            )
            padded_edges += P * cmax * w
        hub = None
        if hub_i < n:
            w = hub_width
            per_shard = []
            for p in range(P):
                rows_g = hub_rows_ps[p]
                lens = deg_sorted[rows_g].astype(np.int64)
                per_shard.append((rows_g, lens, int((-(-lens // w)).sum())))
            vmax = _round_up(max(v for _, _, v in per_shard), row_align)
            hub = ShardBucket(
                width=w,
                start_local=hub_start_local,
                count=vmax,
                real_count=hub_cps,
                nbr=np.zeros((P, vmax, w), dtype=np.int32),
                deg=np.zeros((P, vmax), dtype=np.int32),
                owners=np.zeros((P, vmax), dtype=np.int32),
                phase="dep",
            )
            padded_edges += P * vmax * w

        for p in range(P):
            remap1[:] = 0
            own_g = np.flatnonzero(shard_of == p)
            remap1[own_g] = lrow_of[own_g]
            # hot remote rows (not owned): hot slots
            hg = hot_rows[shard_of[hot_rows] != p]
            remap1[hg] = hot_base + hot_slot[hg]
            # cold remote rows: halo slots
            u, slots = cold_slot[p]
            remap1[u] = halo_base + slots

            for si, (w, sl, cmax, phase, rows_ps) in enumerate(slabs):
                fill(rows_ps[p], w, buckets[si].nbr[p], buckets[si].deg[p])
            if hub is not None:
                w = hub_width
                rows_g, lens, nv = per_shard[p]
                vcounts = -(-lens // w)
                owners_v = np.repeat(rows_g, vcounts)
                vidx = np.arange(nv) - np.repeat(np.cumsum(vcounts) - vcounts, vcounts)
                vdeg = np.minimum(
                    lens[np.repeat(np.arange(len(rows_g)), vcounts)] - vidx * w, w
                )
                total = int(vdeg.sum())
                row_of = np.repeat(np.arange(nv), vdeg)
                within = np.arange(total) - np.repeat(np.cumsum(vdeg) - vdeg, vdeg)
                flat = rowptr[perm[owners_v]][row_of] + vidx[row_of] * w + within
                hub.nbr[p, row_of, within] = remap1[inv_perm[graph.colids[flat]]]
                hub.deg[p, :nv] = vdeg
                hub.owners[p, :nv] = lrow_of[owners_v] - hub_start_local
        if hub is not None:
            buckets.append(hub)

        # --- global-id map of each shard's [local | hot | halo] space --------
        # gmap[p, slot] = degree-sorted GLOBAL row the slot holds (or -1 for
        # never-written padding slots).  Lets the distributed walk engine
        # translate ELL-table entries back to global ids.
        table_len = n_loc + P * Hh + P * H
        gmap = np.full((P, table_len), -1, dtype=np.int32)
        all_g = np.arange(n, dtype=np.int32)
        for p in range(P):
            own_g = all_g[shard_of == p]
            gmap[p, lrow_of[own_g]] = own_g
            hg = hot_rows[shard_of[hot_rows] != p]
            gmap[p, hot_base + hot_slot[hg]] = hg.astype(np.int32)
            u, slots = cold_slot[p]
            gmap[p, halo_base + slots] = u.astype(np.int32)

        # exchange metrics: rows RECEIVED per shard per iteration
        hot_total = int(len(hot_rows))
        stats = {
            "v1_recv_rows_per_shard": P * H_v1,  # uniform worst-pair design
            "v2_recv_rows_per_shard": P * H + P * Hh,
            "v2_cold_pad_width": H,
            "v1_pad_width": H_v1,
            "hot_rows_total": hot_total,
            "hot_min": hot_min,
            "cold_need_total": cold_total,
            "need_total": total_need,
            "reduction": (P * H_v1) / max(P * H + P * Hh, 1),
            "deal": deal,
        }

        return VertexShardLayout(
            n=n,
            n_shards=P,
            n_loc=n_loc,
            halo_width=H,
            hot_width=Hh,
            perm=perm,
            inv_perm=inv_perm,
            shard_of=shard_of,
            lrow_of=lrow_of,
            deg_loc=deg_loc,
            buckets=buckets,
            send_idx=send_idx,
            hot_send=hot_send,
            padded_edges=padded_edges,
            gmap=gmap,
            stats=stats,
        )
