"""End-to-end training smoke + quality-direction tests."""

import os

import numpy as np
import pytest

from force2vec_tpu.graphs import read_mtx
from force2vec_tpu.train.trainer import Force2Vec, TrainConfig

KARATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "karate.mtx")


@pytest.fixture(scope="module")
def karate():
    return read_mtx(KARATE)


@pytest.mark.parametrize(
    "model",
    ["tdist", "sigmoid", "rwalk", "fr", "linlog", "forceatlas", "tdist_exact"],
)
def test_train_smoke_all_models(karate, model):
    fv = Force2Vec(karate, TrainConfig(dim=8, batch_size=16, model=model, ns=3))
    emb = fv.train(iters=5, seed=1)
    assert emb.shape == (karate.n, 8)
    assert np.isfinite(emb).all()


def _edge_vs_random_margin(graph, emb):
    """Mean distance between non-adjacent pairs minus mean distance between
    adjacent pairs — positive means neighbors ended up closer."""
    rng = np.random.default_rng(0)
    src = np.repeat(np.arange(graph.n), graph.degrees)
    d_edge = np.linalg.norm(emb[src] - emb[graph.colids], axis=1).mean()
    a = rng.integers(0, graph.n, 2000)
    b = rng.integers(0, graph.n, 2000)
    keep = a != b
    d_rand = np.linalg.norm(emb[a[keep]] - emb[b[keep]], axis=1).mean()
    return d_rand - d_edge


def test_training_pulls_neighbors_together(karate):
    fv = Force2Vec(karate, TrainConfig(dim=16, batch_size=34, model="tdist", ns=5))
    emb = fv.train(iters=300, seed=1)
    assert _edge_vs_random_margin(karate, emb) > 0.5


def test_training_deterministic_given_seed(karate):
    cfg = TrainConfig(dim=8, batch_size=16, model="tdist", ns=3)
    e1 = Force2Vec(karate, cfg).train(iters=10, seed=5)
    e2 = Force2Vec(karate, cfg).train(iters=10, seed=5)
    np.testing.assert_array_equal(e1, e2)


def test_train_resumable_spans(karate):
    """Splitting a run into host-visible spans is identical to one call."""
    cfg = TrainConfig(dim=8, batch_size=16, model="tdist", ns=3)
    one = Force2Vec(karate, cfg).train(iters=8, seed=2)
    two = Force2Vec(karate, cfg).train(iters=8, seed=2, iters_per_call=3)
    np.testing.assert_allclose(one, two, rtol=1e-6, atol=1e-7)
