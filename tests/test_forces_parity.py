"""Kernel-parity tests: the jitted training step vs the plain-numpy
oracle that mirrors the C++ loops, with identical injected negative samples
and walks (SURVEY.md §4: parity is defined over injected samples, never over
the RNG stream)."""

import numpy as np
import pytest

from force2vec_tpu.models.reference_impl import run_reference
from force2vec_tpu.train.trainer import Force2Vec, TrainConfig

DIM = 16
ITERS = 3


def _run_pair(graph, model, batch_size, ns=4, per_vertex=False, iters=ITERS, seed=7):
    n = graph.n
    rng = np.random.default_rng(seed)
    if model in ("sigmoid", "rwalk"):
        x0 = rng.random((n, DIM)).astype(np.float32)
    else:
        x0 = (rng.random((n, DIM)) * 2 - 1).astype(np.float32)

    cfg = TrainConfig(
        dim=DIM,
        batch_size=batch_size,
        model=model,
        ns=ns,
        per_vertex_samples=per_vertex,
        edge_chunk=64,  # force multiple chunks per batch
        rep_chunk=16,
    )
    fv = Force2Vec(graph, cfg)
    nb = fv.dg.num_batches
    b = fv.dg.batch_size

    m = ns * b if per_vertex else ns
    neg = rng.integers(0, max(n - 1, 1), size=(iters, nb, m)).astype(np.int32)
    walks = None
    if model == "rwalk":
        walks = rng.integers(0, n, size=(iters, n, cfg.walk_length)).astype(np.int32)

    # oracle
    x_ref = run_reference(
        graph, x0, model, iters, b, fv.lr, neg, per_vertex=per_vertex, walks=walks
    )

    # jitted step, iteration by iteration with the same injected samples
    x = fv.pad_embedding(x0)
    step = fv.lr
    for it in range(iters):
        w = None
        if walks is not None:
            wpad = np.zeros((fv.dg.n_pad, cfg.walk_length), dtype=np.int32)
            wpad[:n] = walks[it]
            w = wpad
        x = fv.run_iteration(x, neg_ids=neg[it], walks=w, step=step)
        if fv.model.lr_schedule == "decay999":
            step = np.float32(step * 0.999)
    x_jax = np.asarray(x[:n])
    return x_ref, x_jax


@pytest.mark.parametrize(
    "model", ["tdist", "sigmoid", "fr", "linlog", "forceatlas"]
)
def test_model_parity_shared_negatives(small_graph, model):
    x_ref, x_jax = _run_pair(small_graph, model, batch_size=16)
    np.testing.assert_allclose(x_jax, x_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("model", ["tdist", "sigmoid"])
def test_model_parity_per_vertex_negatives(small_graph, model):
    x_ref, x_jax = _run_pair(small_graph, model, batch_size=16, per_vertex=True)
    np.testing.assert_allclose(x_jax, x_ref, rtol=2e-4, atol=2e-4)


def test_rwalk_parity(small_graph):
    x_ref, x_jax = _run_pair(small_graph, "rwalk", batch_size=16)
    np.testing.assert_allclose(x_jax, x_ref, rtol=2e-4, atol=2e-4)


def test_exact_parity(small_graph):
    x_ref, x_jax = _run_pair(small_graph, "tdist_exact", batch_size=16, iters=2)
    np.testing.assert_allclose(x_jax, x_ref, rtol=3e-4, atol=3e-4)


def test_single_batch_whole_graph(small_graph):
    # batch larger than the graph: one batch of size n (reference NUMSIZE =
    # min(BATCHSIZE, rows), sample/algorithms.cpp:559)
    x_ref, x_jax = _run_pair(small_graph, "tdist", batch_size=4096)
    np.testing.assert_allclose(x_jax, x_ref, rtol=2e-4, atol=2e-4)


def test_uneven_tail_batch(small_graph):
    # n=50 with B=24 → batches 24/24/2: padded tail must not corrupt real rows
    x_ref, x_jax = _run_pair(small_graph, "tdist", batch_size=24)
    np.testing.assert_allclose(x_jax, x_ref, rtol=2e-4, atol=2e-4)


def test_scatter_segment_mode_matches_matmul(small_graph):
    cfg = dict(dim=DIM, batch_size=16, model="tdist", ns=3, edge_chunk=64)
    rng = np.random.default_rng(0)
    x0 = (rng.random((small_graph.n, DIM)) * 2 - 1).astype(np.float32)
    neg = rng.integers(0, small_graph.n - 1, size=(1, 4, 3)).astype(np.int32)

    outs = []
    for mode in ("matmul", "scatter"):
        fv = Force2Vec(small_graph, TrainConfig(segment_mode=mode, **cfg))
        x = fv.run_iteration(fv.pad_embedding(x0), neg_ids=neg[0])
        outs.append(np.asarray(x[: small_graph.n]))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
