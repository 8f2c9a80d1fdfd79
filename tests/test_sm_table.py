"""Sigmoid-table (fast_SM) parity mode.

The reference's sigmoid variants evaluate σ via a 2048-entry lookup table
(init_SM_TABLE/fast_SM, sample/algorithms.cpp:755-776).  Exact sigmoid is
the (cheaper, better) default; ``TrainConfig(sm_table=True)`` switches
the sigmoid family to the table for bit-level parity experiments.  These
tests pin (1) the table semantics against a literal numpy transcription of
the C++ and (2) oracle parity of a full training iteration in table mode.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from force2vec_tpu.graphs.csr import Graph
from force2vec_tpu.models.forces import (
    SM_BOUND,
    get_model,
    make_sm_table,
    table_sigmoid,
)
from force2vec_tpu.models.reference_impl import _fast_sm, run_reference
from force2vec_tpu.train.trainer import Force2Vec, TrainConfig


def _ring_graph(n=40, extra=17):
    rng = np.random.default_rng(5)
    src = np.arange(n)
    dst = (src + 1) % n
    es = rng.integers(0, n, size=extra)
    ed = rng.integers(0, n, size=extra)
    keep = es != ed
    rows = np.concatenate([src, dst, es[keep], ed[keep]])
    cols = np.concatenate([dst, src, ed[keep], es[keep]])
    return Graph.from_coo(rows, cols, None, n=n)


def test_table_matches_cpp_semantics():
    """table_sigmoid == the C++ fast_SM transcription on a dense grid
    (including out-of-range clamps to exactly 0/1)."""
    table = make_sm_table()
    vs = np.linspace(-8.0, 8.0, 4001).astype(np.float32)
    got = np.asarray(table_sigmoid(jnp.asarray(vs), table))
    want = np.array([_fast_sm(float(v)) for v in vs], dtype=np.float32)
    np.testing.assert_allclose(got, want, atol=2e-7)
    assert got[0] == 0.0 and got[-1] == 1.0


def test_table_is_coarser_than_exact():
    """The table is a real approximation (≠ exact σ) — guards against the
    mode silently aliasing the exact path."""
    table = make_sm_table()
    vs = jnp.linspace(-5.9, 5.9, 1001)
    err = np.max(np.abs(np.asarray(table_sigmoid(vs, table))
                        - np.asarray(jax.nn.sigmoid(vs))))
    assert 1e-5 < err < 2e-3  # one table-step of σ slope


def test_get_model_table_variant():
    m = get_model("sigmoid", sm_table=True)
    assert m.name == "sigmoid_table"
    assert get_model("sigmoid", sm_table=True) is m  # cached
    with pytest.raises(ValueError):
        get_model("tdist", sm_table=True)


@pytest.mark.parametrize("model", ["sigmoid"])
def test_table_mode_oracle_parity(model):
    """Batch trainer in sm_table mode vs the numpy oracle running the C++
    fast_SM loop — same injected negatives."""
    graph = _ring_graph()
    n, dim, iters, ns = graph.n, 16, 2, 4
    rng = np.random.default_rng(11)
    x0 = rng.random((n, dim)).astype(np.float32)

    cfg = TrainConfig(dim=dim, batch_size=16, model=model, ns=ns,
                      edge_chunk=64, rep_chunk=16, sm_table=True)
    fv = Force2Vec(graph, cfg)
    assert fv.model.name == f"{model}_table"
    nb, b = fv.dg.num_batches, fv.dg.batch_size
    neg = rng.integers(0, max(n - 1, 1), size=(iters, nb, ns)).astype(np.int32)

    x_ref = run_reference(graph, x0, model, iters, b, fv.lr, neg,
                          sm_table=True)
    x = fv.pad_embedding(x0)
    for it in range(iters):
        x = fv.run_iteration(x, neg_ids=neg[it], step=fv.lr)
    np.testing.assert_allclose(np.asarray(x[:n]), x_ref, atol=2e-4)


def test_table_mode_sync_close_to_exact():
    """Sync schedule: table mode stays within the table's resolution of the
    exact-σ result over one iteration (sanity that wiring reaches sync)."""
    from force2vec_tpu.train.sync import SyncForce2Vec

    graph = _ring_graph(64, 31)
    cfg_t = TrainConfig(dim=16, batch_size=16, model="sigmoid", ns=4,
                        sm_table=True)
    cfg_e = TrainConfig(dim=16, batch_size=16, model="sigmoid", ns=4)
    fvt = SyncForce2Vec(graph, cfg_t, min_width=4, hub_width=16, row_align=4)
    fve = SyncForce2Vec(graph, cfg_e, min_width=4, hub_width=16, row_align=4)
    x0 = fve.init_embedding(seed=3)
    ng = -(-fve.layout.n_pad // 16)
    negs = np.random.default_rng(4).integers(
        0, graph.n - 1, size=(ng, 4)).astype(np.int32)
    xt = np.asarray(fvt.run_iteration(x0, negs))
    xe = np.asarray(fve.run_iteration(x0, negs))
    d = np.max(np.abs(xt - xe))
    assert 0 < d < 5e-3
