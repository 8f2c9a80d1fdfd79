"""Sync-schedule parity: the epoch-synchronous trainer is semantically the
reference at batch_size = n with per-vertex negatives (-bs 1).  The numpy
oracle runs exactly that configuration with the same injected samples
(mapped through the degree-sort relabeling)."""

import numpy as np
import pytest

from force2vec_tpu.graphs.csr import SyncLayout
from force2vec_tpu.models.reference_impl import run_reference
from force2vec_tpu.train.sync import SyncForce2Vec
from force2vec_tpu.train.trainer import TrainConfig

DIM = 16
ITERS = 3


def _run_pair(graph, model, ns=4, iters=ITERS, seed=7, hub_width=16, min_width=4):
    n = graph.n
    rng = np.random.default_rng(seed)
    if model in ("sigmoid", "rwalk"):
        x0 = rng.random((n, DIM)).astype(np.float32)
    else:
        x0 = (rng.random((n, DIM)) * 2 - 1).astype(np.float32)

    # The FR/LinLog/ForceAtlas variants only have batch-shared negatives in
    # the reference; t-dist/sigmoid also have the -bs 1 per-vertex flavor
    # (overlapping windows samples[i : i+ns], algorithms.cpp:719-721).
    per_vertex = model in ("tdist", "sigmoid", "rwalk")
    sfv = SyncForce2Vec(
        graph,
        TrainConfig(
            dim=DIM, batch_size=n, model=model, ns=ns, per_vertex_samples=per_vertex
        ),
        min_width=min_width,
        hub_width=hub_width,
    )
    lay = sfv.layout

    m = ns * n if per_vertex else ns
    buf = rng.integers(0, max(n - 1, 1), size=(iters, 1, m)).astype(np.int32)
    win = np.arange(n)[:, None] + np.arange(ns)[None, :]  # [n, ns] into buf

    walks = None
    if model == "rwalk":
        walks = rng.integers(0, n, size=(iters, n, 5)).astype(np.int32)

    x_ref = run_reference(
        graph, x0, model, iters, n, sfv.lr, buf, per_vertex=per_vertex, walks=walks
    )

    x = sfv.pad_embedding(x0)
    step = sfv.lr
    for it in range(iters):
        if per_vertex:
            neg_orig = buf[it, 0][win]  # [n, ns] original ids
        else:
            neg_orig = np.broadcast_to(buf[it, 0], (n, ns))  # shared
        neg_rel = lay.inv_perm[neg_orig]  # relabeled ids
        neg_pad = np.zeros((lay.n_pad, ns), dtype=np.int32)
        neg_pad[:n] = neg_rel[lay.perm]  # row i (relabeled) gets orig row perm[i]
        w = None
        if walks is not None:
            w = np.zeros((lay.n_pad, 5), dtype=np.int32)
            w[:n] = lay.inv_perm[walks[it][lay.perm]]
        x = sfv.run_iteration(x, neg_pad, walks=w, step=step)
        if sfv.model.lr_schedule == "decay999":
            step = np.float32(step * 0.999)
    return x_ref, sfv.unpad_embedding(x)


@pytest.mark.parametrize("model", ["tdist", "sigmoid", "fr", "linlog", "forceatlas"])
def test_sync_parity(small_graph, model):
    x_ref, x_sync = _run_pair(small_graph, model)
    np.testing.assert_allclose(x_sync, x_ref, rtol=3e-4, atol=3e-4)


def test_sync_parity_rwalk(small_graph):
    x_ref, x_sync = _run_pair(small_graph, "rwalk")
    np.testing.assert_allclose(x_sync, x_ref, rtol=3e-4, atol=3e-4)


def test_sync_layout_covers_all_edges(small_graph):
    lay = SyncLayout.build(small_graph, min_width=4, hub_width=8)
    # every edge appears exactly once across buckets (as a relabeled pair)
    got = []
    for b in lay.buckets:
        for r in range(b.count):
            row = b.owners[r] if b.owners is not None else b.start + r
            for k in range(b.deg[r]):
                got.append((int(row), int(b.nbr[r, k])))
    assert len(got) == small_graph.nnz
    src = np.repeat(np.arange(small_graph.n), small_graph.degrees)
    want = {
        (int(lay.inv_perm[s]), int(lay.inv_perm[d]))
        for s, d in zip(src, small_graph.colids)
    }
    # duplicates collapse in the set; compare as multisets via sorting
    got_sorted = sorted(got)
    want_pairs = sorted(
        (int(lay.inv_perm[s]), int(lay.inv_perm[d]))
        for s, d in zip(src, small_graph.colids)
    )
    assert got_sorted == want_pairs
    assert want.issubset(set(got))


def test_sync_chunked_matches_unchunked(small_graph):
    """A tiny tile budget forces every bucket sweep into many chunks; the
    result must equal the single-chunk program exactly (chunking only
    splits the gather/sweep into independent row slices)."""
    cfg = TrainConfig(
        dim=DIM, batch_size=small_graph.n, model="tdist", ns=4,
        per_vertex_samples=True,
    )
    big = SyncForce2Vec(small_graph, cfg, min_width=4, hub_width=16)
    tiny = SyncForce2Vec(
        small_graph, cfg, min_width=4, hub_width=16, tile_budget_bytes=2048
    )
    rng = np.random.default_rng(3)
    x0 = (rng.random((small_graph.n, DIM)) * 2 - 1).astype(np.float32)
    negs = rng.integers(
        0, small_graph.n, size=(big.layout.n_pad, 4)
    ).astype(np.int32)
    xa = big.run_iteration(big.pad_embedding(x0), negs)
    xb = tiny.run_iteration(tiny.pad_embedding(x0), negs)
    np.testing.assert_array_equal(np.asarray(xa), np.asarray(xb))


def test_sync_grouped_negatives_match_expanded(small_graph):
    """Grouped negatives ([ng, ns]: one shared ns-sample set per
    batch_size-row group — the configuration bench.py times) must equal
    the per-row program fed the explicitly expanded [n_pad, ns] table.
    The per-row path is oracle-parity-tested above, so equality here
    transfers reference parity to the grouped branch."""
    n = small_graph.n
    bs = 8  # several groups: ng > 1 exercises the gid routing
    cfg_g = TrainConfig(dim=DIM, batch_size=bs, model="tdist", ns=4,
                        per_vertex_samples=False)
    cfg_v = TrainConfig(dim=DIM, batch_size=bs, model="tdist", ns=4,
                        per_vertex_samples=True)
    grouped = SyncForce2Vec(small_graph, cfg_g, min_width=4, hub_width=16)
    perrow = SyncForce2Vec(small_graph, cfg_v, min_width=4, hub_width=16)
    lay = grouped.layout
    ng = -(-lay.n_pad // bs)
    rng = np.random.default_rng(11)
    x0 = (rng.random((n, DIM)) * 2 - 1).astype(np.float32)
    negs_g = rng.integers(0, n - 1, size=(ng, 4)).astype(np.int32)
    # expand: relabeled row r belongs to group r // bs
    negs_v = negs_g[np.arange(lay.n_pad) // bs]
    xa = grouped.run_iteration(grouped.pad_embedding(x0), negs_g)
    xb = perrow.run_iteration(perrow.pad_embedding(x0), negs_v)
    np.testing.assert_allclose(np.asarray(xa), np.asarray(xb),
                               rtol=1e-6, atol=1e-6)


def test_sync_quality_karate():
    import os

    from force2vec_tpu.graphs import read_mtx

    g = read_mtx(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "karate.mtx"))
    sfv = SyncForce2Vec(g, TrainConfig(dim=16, model="tdist", ns=5))
    emb = sfv.train(iters=300, seed=1)
    assert np.isfinite(emb).all()
    src = np.repeat(np.arange(g.n), g.degrees)
    d_edge = np.linalg.norm(emb[src] - emb[g.colids], axis=1).mean()
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, g.n, 2000), rng.integers(0, g.n, 2000)
    d_rand = np.linalg.norm(emb[a] - emb[b], axis=1).mean()
    assert d_rand - d_edge > 0.5


def test_sync_hot_cold_split_matches_plain():
    """The hot/cold gather split (compact hot-suffix table + per-run tight
    rectangles) is an exact neighbor-multiset partition: one iteration
    equals the unsplit layout.  Relabelings differ (the split refines
    within-bucket row order), so identical per-vertex negatives are
    injected in ORIGINAL id space and mapped through each runner's perm."""
    from force2vec_tpu.graphs.csr import Graph

    rng = np.random.default_rng(21)
    n, extra = 1500, 900
    src = np.arange(n); dst = (src + 1) % n
    es = rng.integers(0, n, size=extra); ed = rng.integers(0, n, size=extra)
    keep = es != ed
    rows = np.concatenate([src, dst, es[keep], ed[keep]])
    cols = np.concatenate([dst, src, ed[keep], es[keep]])
    graph = Graph.from_coo(rows, cols, None, n=n)

    cfg = TrainConfig(dim=16, batch_size=64, model="tdist", ns=4)
    plain = SyncForce2Vec(graph, cfg, min_width=4, hub_width=16,
                          row_align=4, hot_rows=0)
    split = SyncForce2Vec(graph, cfg, min_width=4, hub_width=16,
                          row_align=4, hot_rows=300)
    assert split.layout.hot_start == graph.n - 300
    assert any(b.hot_spans for b in split.layout.buckets)
    x_host = rng.random((graph.n, 16)).astype(np.float32)
    pv = rng.integers(0, graph.n - 1, size=(graph.n, 4)).astype(np.int32)

    def run(fv):
        npad = fv.layout.n_pad
        pvr = np.zeros((npad, 4), np.int32)
        pvr[:graph.n] = fv.layout.inv_perm[pv[fv.layout.perm]]
        return fv.unpad_embedding(
            fv.run_iteration(fv.pad_embedding(x_host), pvr))

    out_p = run(plain)
    out_s = run(split)
    np.testing.assert_allclose(out_s, out_p, rtol=1e-5, atol=1e-6)


def _split_hot_loop_reference(nbr, dg, w, hot_start):
    """The pre-vectorization per-run Python loop (round-4 shipping code),
    kept verbatim as the behavioral reference pinning the numpy rewrite of
    ``graphs.csr._split_hot``."""
    from force2vec_tpu.graphs.csr import HotSpan, _round_up

    hotm = (nbr >= hot_start) & (np.arange(w)[None, :] < dg[:, None])
    hot_ct = hotm.sum(1).astype(np.int32)
    order = np.argsort(hotm, axis=1, kind="stable")
    packed = np.take_along_axis(nbr, order, axis=1)
    dg_cold = (dg - hot_ct).astype(np.int32)
    wh_row = ((hot_ct + 7) // 8) * 8
    wc_row = ((dg_cold + 7) // 8) * 8
    spans, hrects, crects, cdegs, hdegs = [], [], [], [], []
    hot_off = cold_off = deg_off = 0
    r = 0
    cnt_rows = len(dg)
    while r < cnt_rows:
        e = r
        while (e < cnt_rows and wh_row[e] == wh_row[r]
               and wc_row[e] == wc_row[r]):
            e += 1
        wh = int(wh_row[r])
        cnt = e - r
        r8 = _round_up(cnt, 8)
        rows_ = np.arange(r, e)
        wc = int(((int(dg_cold[rows_].max()) + 7) // 8) * 8)
        cd = np.zeros(r8, dtype=np.int32)
        cd[:cnt] = dg_cold[rows_]
        hd = np.zeros(r8, dtype=np.int32)
        hd[:cnt] = hot_ct[rows_]
        cdegs.append(cd)
        hdegs.append(hd)
        if wc > 0:
            kc = np.arange(wc)[None, :]
            crect = np.zeros((r8, wc), dtype=np.int32)
            crect[:cnt] = np.where(
                kc < dg_cold[rows_][:, None],
                np.take_along_axis(
                    packed[rows_], np.clip(kc, 0, w - 1), axis=1),
                0)
            crects.append(crect.reshape(-1))
        if wh > 0:
            k = np.arange(wh)[None, :]
            src = (w - hot_ct[rows_])[:, None] + k
            rect = np.take_along_axis(
                packed[rows_], np.clip(src, 0, w - 1), axis=1)
            hrect = np.zeros((r8, wh), dtype=np.int32)
            hrect[:cnt] = np.where(
                k < hot_ct[rows_][:, None], rect - hot_start, 0)
            hrects.append(hrect.reshape(-1))
        spans.append(HotSpan(row_off=r, count=cnt,
                             cold_width=wc, cold_off=cold_off,
                             width=wh, flat_off=hot_off,
                             deg_off=deg_off, rows_pad=r8))
        cold_off += r8 * wc
        hot_off += r8 * wh
        deg_off += r8
        r = e
    cat = lambda xs: (np.concatenate(xs) if xs else np.zeros(0, np.int32))
    return cat(crects), cat(cdegs), cat(hdegs), cat(hrects), spans


def test_split_hot_vectorized_matches_loop_reference():
    from force2vec_tpu.graphs.csr import _split_hot

    rng = np.random.default_rng(5)
    for trial, (rows, w, hot_start) in enumerate(
            [(1, 8, 4), (7, 8, 6), (64, 12, 40), (257, 16, 100),
             (800, 8, 700), (333, 24, 10)]):
        n_ids = hot_start + max(rows // 2, 4)
        dg = rng.integers(0, w + 1, size=rows).astype(np.int32)
        # realistic tail: some zero-degree padding rows at the end
        if rows > 8:
            dg[-3:] = 0
        nbr = np.zeros((rows, w), dtype=np.int32)
        for r in range(rows):
            nbr[r, :dg[r]] = rng.integers(0, n_ids, size=dg[r])
        ref = _split_hot_loop_reference(nbr, dg, w, hot_start)
        got = _split_hot(nbr, dg, w, hot_start)
        np.testing.assert_array_equal(got[0], ref[0], err_msg=f"cold {trial}")
        np.testing.assert_array_equal(got[1], ref[1], err_msg=f"cdeg {trial}")
        np.testing.assert_array_equal(got[2], ref[2], err_msg=f"hdeg {trial}")
        np.testing.assert_array_equal(got[3], ref[3], err_msg=f"hot {trial}")
        assert got[4] == ref[4], f"spans differ (trial {trial})"


def test_ell_walks_land_on_neighbors(small_graph):
    """Every walk step's target must be a real neighbor of the previous
    position (or the position itself for degree-0 rows) — validates the
    flat pool+base lookup against the CSR adjacency."""
    import jax

    from force2vec_tpu.train.sync import _ell_walks

    g = small_graph
    fv = SyncForce2Vec(g, TrainConfig(dim=8, model="rwalk", ns=2),
                       min_width=4, hub_width=8)
    lay = fv.layout
    w = np.asarray(_ell_walks(fv._garr, lay, jax.random.PRNGKey(3), 4))
    assert w.shape == (lay.n_pad, 4)
    nbrs = {}  # relabeled adjacency
    src = np.repeat(np.arange(g.n), g.degrees)
    for s, d in zip(lay.inv_perm[src], lay.inv_perm[g.colids]):
        nbrs.setdefault(int(s), set()).add(int(d))
    cur = np.arange(lay.n_pad)
    for step in range(4):
        for v in range(lay.n_pad):
            prev = int(cur[v])
            got = int(w[v, step])
            if prev < g.n and nbrs.get(prev):
                assert got in nbrs[prev], (v, step, prev, got)
            else:
                assert got == prev  # deg-0 / padding stays put
        cur = w[:, step]
