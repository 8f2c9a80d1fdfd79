"""Multi-device tests: the shard_map (dp × tp) step must reproduce the
single-device step exactly — row updates are disjoint across dp ranks and
tp only splits a reduction, so parity is numerical, not statistical."""

import jax
import numpy as np
import pytest

from force2vec_tpu.dist import ShardedForce2Vec, make_mesh
from force2vec_tpu.train.trainer import Force2Vec, TrainConfig

DIM = 16
ITERS = 4


def _single_vs_sharded(graph, model, dp, tp, batch_size=16, seed=3):
    cfg = TrainConfig(dim=DIM, batch_size=batch_size, model=model, ns=4, edge_chunk=64)
    fv = Force2Vec(graph, cfg)
    want = fv.train(iters=ITERS, seed=seed)

    mesh = make_mesh(jax.devices()[: dp * tp], dp=dp, tp=tp)
    sfv = ShardedForce2Vec(Force2Vec(graph, cfg), mesh)
    got = sfv.train(iters=ITERS, seed=seed)
    return want, got


@pytest.mark.parametrize("dp,tp", [(8, 1), (1, 8), (4, 2), (2, 4)])
def test_sharded_matches_single_device_tdist(small_graph, dp, tp):
    want, got = _single_vs_sharded(small_graph, "tdist", dp, tp)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", ["sigmoid", "fr"])
def test_sharded_matches_single_device_other_models(small_graph, model):
    want, got = _single_vs_sharded(small_graph, model, dp=2, tp=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sharded_rejects_indivisible(small_graph):
    cfg = TrainConfig(dim=DIM, batch_size=15, model="tdist", ns=2)
    fv = Force2Vec(small_graph, cfg)
    mesh = make_mesh(jax.devices(), dp=4, tp=2)
    with pytest.raises(ValueError):
        ShardedForce2Vec(fv, mesh)


def test_mesh_helper_shapes():
    mesh = make_mesh(jax.devices(), dp=4, tp=2)
    assert mesh.shape["dp"] == 4 and mesh.shape["tp"] == 2


@pytest.mark.parametrize("dp,tp", [(8, 1), (2, 4)])
def test_sharded_sync_matches_single_device(small_graph, dp, tp):
    from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec
    from force2vec_tpu.train.sync import SyncForce2Vec

    cfg = TrainConfig(dim=DIM, batch_size=small_graph.n, model="tdist", ns=4,
                      per_vertex_samples=True)
    want = SyncForce2Vec(small_graph, cfg, min_width=4, hub_width=16).train(
        iters=ITERS, seed=3
    )
    mesh = make_mesh(jax.devices()[: dp * tp], dp=dp, tp=tp)
    got = ShardedSyncForce2Vec(
        small_graph, cfg, mesh, min_width=4, hub_width=16
    ).train(iters=ITERS, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_grouped_rep_matches_single_device(dp):
    """dp>1 grouped-negative repulsion: each rank's rows map to their
    negative-sample group through the global row id, so the dp-sharded
    run equals the single-device run (batch_size 32 groups, a ring graph
    whose rows split evenly over the ranks)."""
    from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec
    from force2vec_tpu.graphs.csr import Graph
    from force2vec_tpu.train.sync import SyncForce2Vec

    n = 1024
    src = np.arange(n)
    dst = (src + 1) % n
    g = Graph.from_coo(np.concatenate([src, dst]), np.concatenate([dst, src]),
                       None, n=n)
    cfg = TrainConfig(dim=16, batch_size=32, model="tdist", ns=3)
    want = SyncForce2Vec(g, cfg, min_width=4, hub_width=8).train(
        iters=2, seed=9)
    mesh = make_mesh(jax.devices()[:dp], tp=1)
    got = ShardedSyncForce2Vec(g, cfg, mesh, min_width=4, hub_width=8).train(
        iters=2, seed=9)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dp,tp", [(2, 1), (4, 2)])
def test_sharded_sync_hot_cold_split_matches_plain(dp, tp):
    """Hot/cold gather split under dp: each rank sweeps a
    1/dp slice of every span chunk and all_gather reassembles before the
    real-row trim.  Must equal the unsplit single-device run — injected
    per-vertex negatives in ORIGINAL id space make the relabeling
    difference (the split refines within-bucket order) immaterial."""
    from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec
    from force2vec_tpu.graphs.csr import Graph
    from force2vec_tpu.train.sync import SyncForce2Vec

    rng = np.random.default_rng(17)
    n, extra = 1500, 900
    src = np.arange(n); dst = (src + 1) % n
    es = rng.integers(0, n, size=extra); ed = rng.integers(0, n, size=extra)
    keep = es != ed
    rows = np.concatenate([src, dst, es[keep], ed[keep]])
    cols = np.concatenate([dst, src, ed[keep], es[keep]])
    graph = Graph.from_coo(rows, cols, None, n=n)

    cfg = TrainConfig(dim=DIM, batch_size=graph.n, model="tdist", ns=4,
                      per_vertex_samples=True)
    plain = SyncForce2Vec(graph, cfg, min_width=4, hub_width=16,
                          hot_rows=0)
    mesh = make_mesh(jax.devices()[: dp * tp], dp=dp, tp=tp)
    split = ShardedSyncForce2Vec(graph, cfg, mesh, min_width=4,
                                 hub_width=16, hot_rows=300)
    assert split.fv.layout.hot_start == graph.n - 300
    assert any(b.hot_spans for b in split.fv.layout.buckets)

    x_host = rng.random((graph.n, DIM)).astype(np.float32)
    pv = rng.integers(0, graph.n - 1, size=(graph.n, 4)).astype(np.int32)

    def one_iter(fv, run_iteration, pad, unpad, lay):
        pvr = np.zeros((lay.n_pad, 4), np.int32)
        pvr[:graph.n] = lay.inv_perm[pv[lay.perm]]
        return unpad(run_iteration(pad(x_host), pvr))

    want = one_iter(plain, plain.run_iteration, plain.pad_embedding,
                    plain.unpad_embedding, plain.layout)

    # drive the sharded iteration with the same injected negatives
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    fv = split.fv
    lay = fv.layout
    pvr = np.zeros((lay.n_pad, 4), np.int32)
    pvr[:graph.n] = lay.inv_perm[pv[fv.layout.perm]]
    iteration = fv._build_iteration_fn(split.spmd)
    step = jnp.float32(fv.lr)
    sharded = jax.jit(jax.shard_map(
        lambda g, x, negs: iteration(g, x, negs, None, step),
        mesh=mesh, in_specs=(P(), split.x_spec, P()),
        out_specs=split.x_spec, check_vma=False))
    x0 = split.pad_embedding(x_host)
    got = fv.unpad_embedding(sharded(split._garr, x0, jnp.asarray(pvr)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
