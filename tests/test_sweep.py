"""The sync sweep's plain-jnp pieces on the CPU: the masked force sum
against a per-row loop over real slots, zero-degree rows, grouped
repulsion against the expanded per-row program (with a partial last
group), the bf16 gather replica's error band, the segment-sum modes, and
the compile-cache location."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from force2vec_tpu.models.forces import get_model
from force2vec_tpu.ops.segment import segment_sum_into_batch
from force2vec_tpu.train.sync import SyncForce2Vec, masked_force_sum
from force2vec_tpu.train.trainer import TrainConfig

MODELS = ["tdist", "sigmoid", "fr", "linlog", "forceatlas"]
C, K, D = 24, 12, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((C, D)).astype(np.float32)
    xj = rng.standard_normal((C, K, D)).astype(np.float32)
    deg = rng.integers(0, K + 1, C).astype(np.int32)
    deg[0] = 0
    deg[1] = K
    invd = (1.0 / rng.integers(1, 20, C)).astype(np.float32)
    return xi, xj, deg, invd


def _loop_sum(model, kind, xi, xj, deg, invd, step):
    """Per-row sum over the real slots only — no mask involved."""
    out = np.zeros_like(xi)
    for r in range(len(xi)):
        if deg[r] == 0:
            continue
        if kind == "edge":
            f = model.edge_force(xi[r][None, :], xj[r, :deg[r]], invd[r], step)
        else:
            f = model.sample_force(xi[r][None, :], xj[r, :deg[r]], step)
        out[r] = np.asarray(f).sum(axis=0)
    return out


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("kind", ["edge", "sample"])
def test_masked_force_sum_matches_loop(name, kind):
    model = get_model(name)
    xi, xj, deg, invd = _inputs(0)
    got = masked_force_sum(model, kind, jnp.asarray(xi), jnp.asarray(xj),
                           jnp.asarray(deg), jnp.asarray(invd), 0.02)
    want = _loop_sum(model, kind, xi, xj, deg, invd, 0.02)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_masked_force_sum_zero_degree_rows(name):
    """Rows with no real slot contribute exactly zero (the mask zeroes the
    per-pair coefficient; padded slots hold finite rows, as in the
    layout, where they point at row 0)."""
    model = get_model(name)
    xi, xj, _, invd = _inputs(1)
    deg = np.zeros(C, np.int32)
    got = masked_force_sum(model, "edge", jnp.asarray(xi), jnp.asarray(xj),
                           jnp.asarray(deg), jnp.asarray(invd), 0.02)
    np.testing.assert_array_equal(np.asarray(got), 0.0)


@pytest.mark.parametrize("name", ["tdist", "sigmoid", "fr"])
@pytest.mark.parametrize("bs", [24, 40])
def test_grouped_repulsion_partial_last_group(small_graph, name, bs):
    """Group-shared negatives equal the per-row program fed the expanded
    table, with a last group that the padded row range cuts short."""
    cfg_g = TrainConfig(dim=D, batch_size=bs, model=name, ns=4)
    cfg_v = TrainConfig(dim=D, batch_size=bs, model=name, ns=4,
                        per_vertex_samples=True)
    grouped = SyncForce2Vec(small_graph, cfg_g, min_width=4, hub_width=16)
    perrow = SyncForce2Vec(small_graph, cfg_v, min_width=4, hub_width=16)
    n_pad = grouped.layout.n_pad
    assert n_pad % bs, "the last group must be partial"
    ng = -(-n_pad // bs)
    rng = np.random.default_rng(11)
    x0 = (rng.random((small_graph.n, D)) * 2 - 1).astype(np.float32)
    negs_g = rng.integers(0, small_graph.n - 1, size=(ng, 4)).astype(np.int32)
    xa = grouped.run_iteration(grouped.pad_embedding(x0), negs_g)
    xb = perrow.run_iteration(perrow.pad_embedding(x0),
                              negs_g[np.arange(n_pad) // bs])
    np.testing.assert_allclose(np.asarray(xa), np.asarray(xb),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["tdist", "sigmoid", "rwalk"])
def test_bf16_replica_band(small_graph, name):
    """The bf16 gather replica stays within 6e-3 of the f32 path over one
    iteration, and is really in use (the results differ).  Per-row
    negatives include a row's own id, the case where a full-precision xi
    against its rounded copy would give a clamped maximal tdist force."""
    n = small_graph.n
    kw = dict(dim=D, batch_size=n, model=name, ns=4, per_vertex_samples=True)
    f32 = SyncForce2Vec(small_graph, TrainConfig(**kw), min_width=4,
                        hub_width=16)
    b16 = SyncForce2Vec(small_graph, TrainConfig(gather_dtype="bfloat16", **kw),
                        min_width=4, hub_width=16)
    rng = np.random.default_rng(5)
    lo = 0.0 if name in ("sigmoid", "rwalk") else -1.0
    x0 = rng.uniform(lo, 1.0, (n, D)).astype(np.float32)
    n_pad = f32.layout.n_pad
    negs = rng.integers(0, n - 1, size=(n_pad, 4)).astype(np.int32)
    negs[:, 0] = np.arange(n_pad) % n  # self-samples
    walks = None
    if name == "rwalk":
        walks = rng.integers(0, n, size=(n_pad, 5)).astype(np.int32)
    a = np.asarray(f32.run_iteration(f32.pad_embedding(x0), negs, walks=walks))
    b = np.asarray(b16.run_iteration(b16.pad_embedding(x0), negs, walks=walks))
    err = np.max(np.abs(a - b))
    assert 0 < err <= 6e-3, err


@pytest.mark.parametrize("e,b", [(64, 16), (100, 7), (5, 32)])
def test_segment_modes_agree(e, b):
    """scatter and matmul segment sums equal a numpy loop; invalid lanes
    (which can hold NaN forces) contribute nothing."""
    rng = np.random.default_rng(e)
    f = rng.standard_normal((e, 8)).astype(np.float32)
    src = rng.integers(0, b, e).astype(np.int32)
    valid = rng.random(e) < 0.7
    f[~valid] = np.nan
    want = np.zeros((b, 8), np.float32)
    for i in np.flatnonzero(valid):
        want[src[i]] += f[i]
    for mode in ("scatter", "matmul"):
        got = segment_sum_into_batch(jnp.asarray(f), jnp.asarray(src),
                                     jnp.asarray(valid), b, mode=mode)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                                   atol=1e-6, err_msg=mode)


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_location(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set (nothing is set in code);
    otherwise the cache goes to <checkout>/.jax_cache."""
    import jax

    from force2vec_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env_dir))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        if env_dir:
            assert got is None
            assert jax.config.jax_compilation_cache_dir == before
        else:
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
