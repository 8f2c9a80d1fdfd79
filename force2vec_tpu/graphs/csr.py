"""CSR graph container and device layouts.

Host side we keep a plain CSR (numpy int32 rowptr/colids), the same
training-time format as the reference's ``CSR<IT,NT>`` container
(reference: sample/CSR.h:89-96).  For the device we re-lay the graph out for
XLA's static-shape world:

* vertices are padded to a whole number of batches so every minibatch has
  identical shape (the reference instead guards every loop with
  ``if (i >= graph.rows) continue`` — sample/algorithms.cpp:590);
* edges stay in CSR order, which means each batch's edges form one
  *contiguous* slice of ``colids`` — the device step walks that slice in
  fixed-size chunks, which replaces the reference's
  per-thread nnz load balancing (sample/algorithms.cpp:2483-2511): an
  edge-centric schedule is balanced by construction;
* an explicit ``edge_src`` array (the expanded rowptr) gives every edge its
  source vertex so a chunk of edges can be segment-reduced into batch rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Host-side CSR adjacency.

    Mirrors the capability of the reference CSR container
    (sample/CSR.h:89-96): ``rowptr``/``colids``/optional ``values`` over
    ``n`` vertices.  Column ids within a row are sorted ascending, matching
    the reference's counting-sort construction (sample/CSC.h:147-190 →
    sample/CSR.h:155-186).
    """

    n: int
    rowptr: np.ndarray  # [n+1] int64-safe int32
    colids: np.ndarray  # [nnz] int32
    values: Optional[np.ndarray] = None  # [nnz] float32 (unused by training)

    @property
    def nnz(self) -> int:
        return int(self.colids.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.rowptr)

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        vals: Optional[np.ndarray],
        n: int,
        sum_duplicates: bool = False,
    ) -> "Graph":
        """Build CSR from COO by counting sort (rows then cols ascending).

        The reference keeps duplicate entries as distinct nonzeros (its CSC
        constructor does not merge unless asked, sample/CSC.h:147-190), so we
        default to keeping duplicates too.
        """
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        if vals is not None:
            vals = np.asarray(vals, dtype=np.float32)[order]
        if sum_duplicates and rows.size:
            keep = np.ones(rows.size, dtype=bool)
            keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            if vals is not None:
                group = np.cumsum(keep) - 1
                vals = np.bincount(group, weights=vals).astype(np.float32)
            rows, cols = rows[keep], cols[keep]
        rowptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(rowptr, rows + 1, 1)
        np.cumsum(rowptr, out=rowptr)
        return Graph(
            n=n,
            rowptr=rowptr.astype(np.int64),
            colids=cols.astype(np.int32),
            values=vals,
        )

    def shuffled_ids(self, seed: int = 0) -> "Graph":
        """Per-row shuffle of colids (parity with CSR::shuffleIds,
        sample/CSR.h:430-447). Training never needs it; provided for
        completeness."""
        rng = np.random.default_rng(seed)
        rows = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)
        # random sort key within each row: lexsort is stable on rows, so
        # the per-row order is an independent uniform shuffle
        order = np.lexsort((rng.random(self.nnz), rows))
        values = self.values[order] if self.values is not None else None
        return Graph(self.n, self.rowptr.copy(), self.colids[order], values)

    def induced_subgraph(self, nodes: np.ndarray) -> "Graph":
        """CSR of the subgraph induced by ``nodes`` (relabeled 0..k-1).

        The reference's big-graph link-prediction script evaluates on the
        first ``size`` vertices (performancescores/biglinkprediction.py);
        passing ``np.arange(size)`` reproduces that subsample.
        """
        nodes = np.asarray(nodes, dtype=np.int64)
        remap = np.full(self.n, -1, dtype=np.int64)
        remap[nodes] = np.arange(len(nodes))
        src = np.repeat(np.arange(self.n), self.degrees)
        keep = (remap[src] >= 0) & (remap[self.colids] >= 0)
        rows = remap[src[keep]]
        cols = remap[self.colids[keep]]
        vals = self.values[keep] if self.values is not None else None
        return Graph.from_coo(rows, cols, vals, n=len(nodes))

    def is_sorted(self) -> bool:
        """Row-wise sortedness check (parity with CSR::Sorted,
        used by the driver at Test/Force2Vec.cpp:123).  Vectorized: a
        decrease in colids is only allowed at a row boundary."""
        if self.nnz < 2:
            return True
        dec = np.flatnonzero(self.colids[1:].astype(np.int64)
                             < self.colids[:-1].astype(np.int64)) + 1
        if not len(dec):
            return True
        # every decrease position must be some row's first edge
        starts = self.rowptr[1:-1]  # interior row starts
        return bool(np.all(np.isin(dec, starts)))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _split_hot(nbr: np.ndarray, dg: np.ndarray, w: int, hot_start: int,
               align: int = 8):
    """Partition a filled ELL rectangle into per-run cold + hot rectangles.

    Runs are maximal row spans of equal (⌈hot/8⌉·8, ⌈cold/8⌉·8) width
    class; BOTH rectangles are tight, so no full-width cold padding
    survives (that padding would be fetched from the big table and erase
    the point of the compact copy).

    Fully vectorized: run boundaries by flatnonzero over the width-class
    arrays, rectangle fill by one flat scatter per stream.  The previous
    per-row Python while-loop dominated the com-Orkut-scale layout build;
    this pass is O(count·w) numpy.

    Returns ``(cold_flat, cdeg, hdeg, hot_flat, spans)`` where the flats
    are 1-D int32 (hot ids LOCAL to the hot suffix), the deg arrays are
    span-row-padded, and ``spans`` is a list of :class:`HotSpan`.
    """
    cnt_rows = len(dg)
    hotm = (nbr >= hot_start) & (np.arange(w)[None, :] < dg[:, None])
    hot_ct = hotm.sum(1).astype(np.int32)
    # stable argsort of booleans packs each row as
    # [cold valid..., padding..., hot...] (False slots keep their order)
    order = np.argsort(hotm, axis=1, kind="stable")
    packed = np.take_along_axis(nbr, order, axis=1)
    dg_cold = (dg - hot_ct).astype(np.int32)
    wh_row = ((hot_ct + 7) // 8) * 8
    wc_row = ((dg_cold + 7) // 8) * 8

    empty = np.zeros(0, dtype=np.int32)
    if cnt_rows == 0:
        return empty, empty, empty, empty, []

    change = np.flatnonzero(
        (wh_row[1:] != wh_row[:-1]) | (wc_row[1:] != wc_row[:-1])) + 1
    starts = np.concatenate([[0], change]).astype(np.int64)
    ends = np.concatenate([change, [cnt_rows]]).astype(np.int64)
    counts = ends - starts
    # rectangles/deg rows padded to whole ``align``-row blocks (a
    # dp-sharded runner passes align divisible by n_dp so
    # every span chunk splits evenly across ranks) — pad rows: deg 0, ids 0
    assert align % 8 == 0, f"span align {align} must be a multiple of 8"
    r8s = ((counts + align - 1) // align) * align
    whs = wh_row[starts].astype(np.int64)
    wcs = wc_row[starts].astype(np.int64)
    cold_offs = np.concatenate([[0], np.cumsum(r8s * wcs)])
    hot_offs = np.concatenate([[0], np.cumsum(r8s * whs)])
    deg_offs = np.concatenate([[0], np.cumsum(r8s)])

    run_id = np.repeat(np.arange(len(starts)), counts)
    local = np.arange(cnt_rows, dtype=np.int64) - starts[run_id]

    cdeg = np.zeros(int(deg_offs[-1]), dtype=np.int32)
    hdeg = np.zeros(int(deg_offs[-1]), dtype=np.int32)
    deg_pos = deg_offs[run_id] + local
    cdeg[deg_pos] = dg_cold
    hdeg[deg_pos] = hot_ct

    # element-level index arrays are the memory-traffic hot spot at
    # com-Orkut scale (~200M cold slots); int32 positions halve that
    # traffic and are safe whenever the flats fit int32 (guarded)
    idt = (np.int32 if max(cold_offs[-1], hot_offs[-1], cnt_rows) < 2**31
           else np.int64)

    def elem_index(lens):
        """(row_rep, k): per-element row id and within-row rank for the
        ragged stream with ``lens[row]`` elements per row."""
        tot = int(lens.sum())
        cum = np.cumsum(lens, dtype=np.int64)
        row_rep = np.repeat(np.arange(cnt_rows, dtype=idt), lens)
        k = (np.arange(tot, dtype=idt)
             - np.repeat((cum - lens).astype(idt), lens))
        return row_rep, k

    cold_flat = np.zeros(int(cold_offs[-1]), dtype=np.int32)
    if int(dg_cold.sum()):
        row_rep, k = elem_index(dg_cold)
        base = (cold_offs[run_id] + local * wcs[run_id]).astype(idt)
        cold_flat[np.repeat(base, dg_cold) + k] = packed[row_rep, k]

    hot_flat = np.zeros(int(hot_offs[-1]), dtype=np.int32)
    if int(hot_ct.sum()):
        row_rep, k = elem_index(hot_ct)
        base = (hot_offs[run_id] + local * whs[run_id]).astype(idt)
        # hot slots sit in the LAST hot_ct columns of the packed row
        src_col = (w - np.repeat(hot_ct, hot_ct).astype(idt)) + k
        hot_flat[np.repeat(base, hot_ct) + k] = (
            packed[row_rep, src_col] - hot_start)

    spans = [
        HotSpan(row_off=int(s), count=int(c), cold_width=int(wc),
                cold_off=int(co), width=int(wh), flat_off=int(ho),
                deg_off=int(do), rows_pad=int(r8))
        for s, c, wc, co, wh, ho, do, r8 in zip(
            starts, counts, wcs, cold_offs[:-1], whs, hot_offs[:-1],
            deg_offs[:-1], r8s)
    ]
    return cold_flat, cdeg, hdeg, hot_flat, spans


@dataclasses.dataclass
class HotSpan:
    """A contiguous row run of one bucket stored as TWO tight rectangles:
    cold slots ([count, cold_width] inside the bucket's flat ``nbr``,
    relabeled ids) and hot slots ([count, hot_width] inside ``hot_flat``,
    ids LOCAL to the hot suffix, i.e. relabeled id − hot_start).  Runs are
    grouped by hot-width class (rows sorted by hot count within the
    bucket), so both rectangles pad by < 8 slots/row plus the bucket's
    narrow degree band."""

    row_off: int  # first row of the run, relative to the bucket
    count: int  # REAL rows; rectangles are stored with ``rows_pad`` rows
    cold_width: int  # cold ELL width (ceil-8 of the run's cold counts; 0 ⇒ none)
    cold_off: int  # element offset into EllBucket.nbr (flat when split)
    width: int  # hot ELL width (ceil-8 of the run's hot counts; 0 ⇒ none)
    flat_off: int  # element offset into EllBucket.hot_flat
    deg_off: int = 0  # row offset into the bucket's span-padded deg arrays
    rows_pad: int = 0  # stored rect rows: count rounded up to the span align


@dataclasses.dataclass
class EllBucket:
    """One degree bucket of the sync layout: ``count`` rows of ELL width
    ``width`` starting at row ``start`` of the degree-sorted table.  For the
    hub bucket (``owners is not None``) the rows are *virtual* — partial
    rows of width ``width`` owned by real rows ``owners`` — and their
    partial force sums are segment-reduced into the owner rows.

    With a hot/cold split (SyncLayout.build(hot_rows=...)): ``nbr``/``deg``
    hold only the COLD slots; the hot slots live in ``hot_flat`` as
    per-run rectangles (``hot_spans``), with per-row hot counts in
    ``hot_deg``.  Force contributions are the sum of both parts — the
    split is exact (a neighbor multiset partition)."""

    width: int
    start: int  # first (relabeled) real row, or 0 for the hub bucket
    count: int  # number of (virtual) rows, padded to a multiple of 8
    nbr: np.ndarray  # [count, width] int32 relabeled neighbor ids (0-padded)
    deg: np.ndarray  # [count] int32 valid neighbors per row
    owners: Optional[np.ndarray] = None  # [count] int32 relabeled owner rows
    hot_flat: Optional[np.ndarray] = None  # 1-D int32 hot-LOCAL ids
    hot_deg: Optional[np.ndarray] = None  # [count] int32 hot slots per row
    hot_spans: Optional[list] = None  # list[HotSpan]


@dataclasses.dataclass
class SyncLayout:
    """Degree-sorted ELL layout for the epoch-synchronous (sync) schedule.

    The sync schedule is the reference's own semantics at ``batch_size = n``
    (one batch per iteration — every read sees iteration-start X, one apply
    per iteration; sample/algorithms.cpp:569-639 with NUMSIZE = n).  On the
    device it removes the serial batch chain entirely: one iteration is one
    fused device computation.

    Vertices are relabeled by ascending degree so that each power-of-two
    ELL bucket is a *contiguous* row range of the permuted embedding table:
    per-bucket updates apply with ``dynamic_update_slice`` — no scatter.
    Rows with degree > ``hub_width`` are split into virtual rows of width
    ``hub_width`` (force formulas are per-edge sums, so the split is exact);
    their partials reduce into owner rows with one small segment-sum.
    """

    n: int
    n_pad: int
    perm: np.ndarray  # [n] original id of relabeled row i
    inv_perm: np.ndarray  # [n] relabeled row of original id
    deg: np.ndarray  # [n_pad] int32 degree per relabeled row (0 for padding)
    buckets: list  # list[EllBucket]
    padded_edges: int  # Σ count·width — the gather volume per iteration
    # hot/cold split: relabeled row where the hot suffix begins, or None.
    # Gathers of the high-degree suffix (which power-law graphs hit for
    # 40%+ of slots) then read a COMPACT copy of that suffix; whether
    # that pays on a GPU is an open question (PERF.md).
    hot_start: Optional[int] = None

    @staticmethod
    def widths_for(min_width: int, hub_width: int, scheme: str = "pow2"):
        """Bucket width ladder from ``min_width`` up to ``hub_width``.

        ``pow2`` doubles each step (round-1/2 behavior).  ``mult4``/``mult8``
        insert intermediate widths (multiples of 4 / 8 within each octave):
        counted on the bench graph they cut ELL padding from 1.39x nnz to
        1.11x / 1.24x, and the bulk-gather bytes are proportional to padded
        rows.
        """
        step_of = {"pow2": None, "mult8": 8, "mult4": 4}[scheme]
        widths = []
        w = min_width
        while w < hub_width:
            widths.append(w)
            if step_of is None:
                w *= 2
            else:
                # quarter-octave steps, kept multiples of step_of
                inc = max(step_of, (w // 4 // step_of) * step_of)
                w += inc
        widths.append(hub_width)
        return widths

    @staticmethod
    def build(
        graph: Graph,
        min_width: int = 8,
        hub_width: int = 256,
        row_align: int = 8,
        widths: Optional[list] = None,
        hot_rows: int = 0,
        span_align: int = 8,
    ) -> "SyncLayout":
        n = graph.n
        deg_orig = graph.degrees.astype(np.int64)
        perm = np.argsort(deg_orig, kind="stable").astype(np.int32)
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(n, dtype=np.int32)
        deg_sorted = deg_orig[perm]

        def fill_ell(rows: np.ndarray, width: int):
            """Vectorized ELL fill: [len(rows), width] relabeled neighbor ids
            (0-padded) + per-row valid counts, for relabeled rows ``rows``
            whose degrees are all ≤ width."""
            lens = deg_sorted[rows]
            total = int(lens.sum())
            nbr = np.zeros((len(rows), width), dtype=np.int32)
            dg = lens.astype(np.int32)
            if total:
                it = np.int32 if total < 2**31 else np.int64
                cum = np.cumsum(lens, dtype=np.int64)
                row_of = np.repeat(np.arange(len(rows), dtype=it), lens)
                within = (np.arange(total, dtype=it)
                          - np.repeat((cum - lens).astype(it), lens))
                flat = graph.rowptr[perm[rows]][row_of] + within
                nbr[row_of, within] = inv_perm[graph.colids[flat]]
            return nbr, dg

        if widths is None:
            widths = SyncLayout.widths_for(min_width, hub_width, "pow2")
        else:
            widths = sorted(set(int(w) for w in widths))
            assert widths[-1] == hub_width, "width ladder must end at hub_width"

        # bucket boundaries from the (globally sorted) degree order — fixed
        # BEFORE any within-bucket reorder
        bounds = []
        i = 0
        for w in widths:
            j = int(np.searchsorted(deg_sorted, w, side="right"))
            if j > i:
                bounds.append((w, i, j))
                i = j
        hub_start_row = i

        # hot/cold split: the hot MEMBER SET is the top ``hot_rows`` rows of
        # the initial degree order; within-bucket reorders sort hot members
        # to their bucket's tail, so the set stays the exact contiguous
        # suffix [n - hot_rows, n) of the FINAL relabeling (only the one
        # bucket containing the threshold has mixed membership)
        hot_start = None
        if hot_rows > 0 and 0 < n - hot_rows:
            hot_start = n - hot_rows

        if hot_start is not None:
            # hot membership per ORIGINAL id (invariant under reorder)
            hot_member = np.zeros(n, dtype=bool)
            hot_member[perm[hot_start:]] = True
            cs = np.concatenate(
                [[0], np.cumsum(hot_member[graph.colids], dtype=np.int64)])
            hot_cnt_orig = cs[graph.rowptr[1:]] - cs[graph.rowptr[:-1]]
            for _, bi_, bj_ in bounds:
                h = hot_cnt_orig[perm[bi_:bj_]]
                c = deg_orig[perm[bi_:bj_]] - h
                # three-level key: hot membership (keeps the suffix exact),
                # then hot-width class, then cold-width class — runs of
                # equal (⌈hot/8⌉, ⌈cold/8⌉) get BOTH rectangles tight to
                # < 8 pad slots/row
                order = np.lexsort(
                    ((c + 7) // 8, (h + 7) // 8, hot_member[perm[bi_:bj_]]))
                perm[bi_:bj_] = perm[bi_:bj_][order]
            inv_perm[perm] = np.arange(n, dtype=np.int32)
            deg_sorted = deg_orig[perm]

        buckets = []
        padded_edges = 0
        # non-hub buckets: contiguous runs of the degree-sorted order
        for w, i, j in bounds:
            count = _round_up(j - i, row_align)
            rows = np.arange(i, j)
            nbr_j, dg_j = fill_ell(rows, w)
            nbr = np.zeros((count, w), dtype=np.int32)
            dg = np.zeros(count, dtype=np.int32)
            nbr[: j - i] = nbr_j
            dg[: j - i] = dg_j
            if hot_start is not None:
                cflat, cdeg, hdeg, hflat, hspans = _split_hot(
                    nbr, dg, w, hot_start, align=span_align)
                buckets.append(EllBucket(
                    width=w, start=i, count=count, nbr=cflat, deg=cdeg,
                    hot_flat=hflat, hot_deg=hdeg, hot_spans=hspans))
                padded_edges += sum(
                    sp.rows_pad * (sp.width + sp.cold_width)
                    for sp in hspans)
            else:
                buckets.append(EllBucket(
                    width=w, start=i, count=count, nbr=nbr, deg=dg))
                padded_edges += count * w
        i = hub_start_row

        # hub bucket: rows with deg > hub_width, split into virtual rows
        if i < n:
            w = hub_width
            hub_rows = np.arange(i, n)
            lens = deg_sorted[hub_rows].astype(np.int64)
            vcounts = -(-lens // w)  # virtual rows per hub row
            nv = int(vcounts.sum())
            owners_v = np.repeat(hub_rows, vcounts).astype(np.int32)
            # index of each virtual row within its owner
            vidx = np.arange(nv) - np.repeat(np.cumsum(vcounts) - vcounts, vcounts)
            vdeg = np.minimum(lens[np.repeat(np.arange(len(hub_rows)), vcounts)] - vidx * w, w)
            total = int(vdeg.sum())
            row_of = np.repeat(np.arange(nv), vdeg)
            within = np.arange(total) - np.repeat(np.cumsum(vdeg) - vdeg, vdeg)
            flat = (
                graph.rowptr[perm[owners_v]][row_of] + vidx[row_of] * w + within
            )
            count = _round_up(nv, row_align)
            nbr = np.zeros((count, w), dtype=np.int32)
            dg = np.zeros(count, dtype=np.int32)
            owners = np.full(count, i, dtype=np.int32)  # pad rows own row i (deg 0 ⇒ no-op)
            nbr[row_of, within] = inv_perm[graph.colids[flat]]
            dg[:nv] = vdeg
            owners[:nv] = owners_v
            buckets.append(
                EllBucket(width=w, start=i, count=count, nbr=nbr, deg=dg, owners=owners)
            )
            padded_edges += count * w

        # The table must cover every bucket's padded row range: XLA CLAMPS
        # out-of-range dynamic_slice starts, which would silently shift a
        # tail bucket onto its neighbor's rows.
        max_extent = max(
            [n] + [b.start + b.count for b in buckets if b.owners is None]
            + [b.start + sp.row_off + sp.rows_pad
               for b in buckets if b.hot_spans
               for sp in b.hot_spans]
        )
        n_pad = _round_up(max_extent, row_align)
        deg_pad = np.zeros(n_pad, dtype=np.int32)
        deg_pad[:n] = deg_sorted
        return SyncLayout(
            n=n,
            n_pad=n_pad,
            perm=perm,
            inv_perm=inv_perm,
            deg=deg_pad,
            buckets=buckets,
            padded_edges=padded_edges,
            hot_start=hot_start,
        )


@dataclasses.dataclass
class DeviceGraph:
    """Static-shape device layout of a :class:`Graph` for one batch size.

    ``n_pad = num_batches * batch_size`` so each minibatch is a fixed
    ``[B, D]`` slice of the (padded) embedding table.  ``colids``/``edge_src``
    are padded by at least one chunk with sentinel edges (dst=0, src=0) that
    every kernel masks out via the per-batch edge extent ``rowptr[b1]``.
    """

    n: int
    n_pad: int
    nnz: int
    batch_size: int
    num_batches: int
    edge_chunk: int
    rowptr: np.ndarray  # [n_pad+1] int32, rowptr[i]=nnz for i>=n
    colids: np.ndarray  # [nnz_pad] int32
    edge_src: np.ndarray  # [nnz_pad] int32
    deg: np.ndarray  # [n_pad] int32 (0 for padded rows)
    max_batch_edges: int

    @staticmethod
    def build(graph: Graph, batch_size: int, edge_chunk: int = 2048) -> "DeviceGraph":
        n = graph.n
        b = min(batch_size, n)
        num_batches = -(-n // b)
        n_pad = num_batches * b
        nnz = graph.nnz
        nnz_pad = _round_up(nnz, edge_chunk) + edge_chunk

        rowptr = np.full(n_pad + 1, nnz, dtype=np.int32)
        rowptr[: n + 1] = graph.rowptr.astype(np.int32)

        colids = np.zeros(nnz_pad, dtype=np.int32)
        colids[:nnz] = graph.colids

        edge_src = np.zeros(nnz_pad, dtype=np.int32)
        edge_src[:nnz] = np.repeat(
            np.arange(n, dtype=np.int32), graph.degrees.astype(np.int64)
        )

        deg = np.zeros(n_pad, dtype=np.int32)
        deg[:n] = graph.degrees.astype(np.int32)

        starts = rowptr[0 : n_pad : b].astype(np.int64)
        ends = rowptr[b : n_pad + 1 : b].astype(np.int64)
        max_batch_edges = int((ends - starts).max()) if num_batches else 0

        return DeviceGraph(
            n=n,
            n_pad=n_pad,
            nnz=nnz,
            batch_size=b,
            num_batches=num_batches,
            edge_chunk=edge_chunk,
            rowptr=rowptr,
            colids=colids,
            edge_src=edge_src,
            deg=deg,
            max_batch_edges=max_batch_edges,
        )
