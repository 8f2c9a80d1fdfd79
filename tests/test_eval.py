"""Evaluation-suite tests: protocol sanity plus an end-to-end quality gate
on cora (the reference's acceptance style, SURVEY.md §4 item 3)."""

import os

import numpy as np
import pytest

from force2vec_tpu.eval import (
    clustering_scores,
    link_prediction_scores,
    make_link_prediction_data,
    modularity,
    node_classification_scores,
    read_node_labels,
)
from force2vec_tpu.graphs import read_mtx
from force2vec_tpu.train.trainer import Force2Vec, TrainConfig

REF_INPUT = "/root/reference/datasets/input"
KARATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "karate.mtx")


@pytest.fixture(scope="module")
def karate():
    return read_mtx(KARATE)


def test_linkpred_dataset_shape(karate):
    emb = np.random.default_rng(0).normal(size=(karate.n, 8)).astype(np.float32)
    X, y = make_link_prediction_data(karate, emb)
    n_pos = int(y.sum())
    assert n_pos == karate.nnz // 2  # one positive per upper-triangle edge
    assert (len(y) - n_pos) >= n_pos  # ~2 negatives per positive (capped)
    assert X.shape == (len(y), 8)


def test_linkpred_learns_structure(karate):
    # trained embeddings must beat random embeddings at link prediction
    fv = Force2Vec(karate, TrainConfig(dim=16, batch_size=34, model="tdist", ns=5))
    emb = fv.train(iters=300, seed=1)
    trained = link_prediction_scores(karate, emb, seed=0)
    rand = np.random.default_rng(0).normal(size=emb.shape).astype(np.float32)
    random_scores = link_prediction_scores(karate, rand, seed=0)
    assert trained["auc"] > random_scores["auc"] + 0.1
    assert trained["auc"] > 0.65


def test_modularity_known_partition(karate):
    # the two-community split of the karate club has modularity ~0.35;
    # a single-community partition has modularity 0 by definition
    assert abs(modularity(karate, np.zeros(karate.n, dtype=int))) < 1e-9
    # random partitions hover near 0
    rng = np.random.default_rng(0)
    q_rand = modularity(karate, rng.integers(0, 4, karate.n))
    assert q_rand < 0.2


def test_clustering_scores(karate):
    fv = Force2Vec(karate, TrainConfig(dim=16, batch_size=34, model="tdist", ns=5))
    emb = fv.train(iters=200, seed=1)
    out = clustering_scores(karate, emb, k_range=range(2, 8))
    assert out["best_modularity"] > 0.1


def test_node_labels_reader(tmp_path):
    p = tmp_path / "labels.txt"
    p.write_text("1 0\n2 1\n2 3\n3 1\n")
    labels = read_node_labels(str(p), 4)
    assert labels == [[0], [1, 3], [1], []]


def test_node_classification_cora():
    graph = read_mtx(os.path.join(REF_INPUT, "cora.mtx"))
    labels = read_node_labels(os.path.join(REF_INPUT, "cora.nodes.labels"), graph.n)
    assert sum(1 for l in labels if l) == graph.n  # every node labeled
    fv = Force2Vec(graph, TrainConfig(dim=32, batch_size=256, model="tdist", ns=5))
    emb = fv.train(iters=150, seed=1)
    scores = node_classification_scores(emb, labels, train_fracs=(0.25,), seed=0)
    # 7-class cora: random guessing gives ~0.14 micro-F1
    assert scores[0.25]["f1_micro"] > 0.35


def test_visualize_writes_file(karate, tmp_path):
    from force2vec_tpu.eval.visualize import draw_communities

    emb = np.random.default_rng(0).normal(size=(karate.n, 8))
    out = str(tmp_path / "vis.pdf")
    draw_communities(emb, np.zeros(karate.n, dtype=int), out)
    assert os.path.getsize(out) > 0


def test_graph_reconstruction(karate):
    from force2vec_tpu.eval.reconstruction import graph_reconstruction_accuracy

    fv = Force2Vec(karate, TrainConfig(dim=16, batch_size=34, model="tdist", ns=5))
    emb = fv.train(iters=300, seed=1)
    acc = graph_reconstruction_accuracy(karate, emb, num_vertices=34, seed=0)
    rand = np.random.default_rng(0).normal(size=emb.shape)
    acc_rand = graph_reconstruction_accuracy(karate, rand, num_vertices=34, seed=0)
    assert acc > acc_rand + 0.1
    assert acc > 0.3


def test_induced_subgraph(karate):
    sub = karate.induced_subgraph(np.arange(10))
    assert sub.n == 10
    # edges of the subgraph are exactly karate's edges among nodes 0..9
    src = np.repeat(np.arange(karate.n), karate.degrees)
    want = sum(1 for s, d in zip(src, karate.colids) if s < 10 and d < 10)
    assert sub.nnz == want
