"""force2vec_tpu — a force-directed graph embedding framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
HipGraph/Force2Vec (ICDM'20): minibatch-SGD force-directed graph embedding
with t-distribution / sigmoid / LinLog / ForceAtlas / Fruchterman-Reingold
force models, negative sampling, and a random-walk variant — plus the
surrounding framework the reference lacks: tests, checkpointing, profiling,
multi-device sharding and an evaluation suite.

Quick start::

    from force2vec_tpu import load_graph, Force2Vec
    g = Force2Vec(load_graph("cora.mtx"), dim=128, batch_size=256)
    emb = g.train(iters=1200)
"""

from force2vec_tpu.graphs import Graph, load_graph, read_mtx
from force2vec_tpu.graphs.io import read_embeddings, write_embeddings
from force2vec_tpu.models.forces import FORCE_MODELS, get_model
from force2vec_tpu.train.trainer import Force2Vec, TrainConfig

__version__ = "0.1.0"

__all__ = [
    "Graph",
    "load_graph",
    "read_mtx",
    "read_embeddings",
    "write_embeddings",
    "FORCE_MODELS",
    "get_model",
    "Force2Vec",
    "TrainConfig",
]
