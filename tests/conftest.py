"""Test env: force the CPU backend with 8 virtual devices, so multi-device
sharding tests run anywhere (SURVEY.md §4 test strategy).  The env var is
overwritten (not setdefault) and the jax config updated after import, so a
GPU visible to the process does not take the tests over; tests that need
the card are marked ``gpu`` and decide inside the test whether one exists.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from force2vec_tpu.graphs.csr import Graph

REFERENCE_DATA = "/root/reference/datasets"


def make_random_graph(n: int, p: float, seed: int = 0) -> Graph:
    """Symmetric Erdős–Rényi graph with no self-loops, every vertex given at
    least one edge (isolated vertices would hit the reference's own deg-0
    quirks, which are out of scope for force parity)."""
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    a = np.triu(a, k=1)
    a = a | a.T
    # ensure no isolated vertices
    for i in range(n):
        if not a[i].any():
            j = (i + 1) % n
            a[i, j] = a[j, i] = True
    rows, cols = np.nonzero(a)
    return Graph.from_coo(rows, cols, None, n=n)


@pytest.fixture
def small_graph():
    return make_random_graph(50, 0.08, seed=3)
