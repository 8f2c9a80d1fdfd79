"""The Force2Vec force-model family, as pure JAX edge/sample functions.

Each model is two pure functions over embedding rows plus declarative
metadata (init distribution, update rule, learning-rate schedule).  The
training loop broadcasts these over edge chunks and negative-sample blocks;
XLA fuses the elementwise math into the surrounding gather/matmul, which
replaces the reference's ~4K lines of hand-unrolled
AVX512 register kernels (sample/algorithms.cpp:1232-4051, sample/kgen/).

Model → reference map (option numbers are the CLI ``-option`` values,
Test/Force2Vec.cpp:129-188):

=============  ======  ==========================================================
model          option  reference method (sample/algorithms.cpp)
=============  ======  ==========================================================
tdist          5       AlgoForce2VecNS (:544-652), t-distribution + neg sampling
sigmoid        6       AlgoForce2VecNSRW (:778-932), sigmoid on dot products
rwalk          7       AlgoForce2VecNSRWEFF (:1063-1203), sigmoid over 5-step walks
fr             2       AlgoForce2VecFR (:155-247), Fruchterman-Reingold flavor
linlog         3       AlgoForce2VecLL (:249-341)
forceatlas     4       AlgoForce2VecFA (:60-153)
tdist_exact    1       AlgoForce2Vec (:344-445), O(n²) exact repulsion
=============  ======  ==========================================================
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

# Gradient clamp bound (reference MAXBOUND, sample/algorithms.h:42 and
# scale(), sample/algorithms.cpp:6-10).
MAXBOUND = 5.0

# Fast-sigmoid table parameters (sample/algorithms.h:43-49).
SM_TABLE_SIZE = 2048
SM_BOUND = 6.0
SM_RESOLUTION = SM_TABLE_SIZE / (2.0 * SM_BOUND)


def _clamp(x):
    return jnp.clip(x, -MAXBOUND, MAXBOUND)


def make_sm_table() -> jnp.ndarray:
    """Precomputed 2048-entry sigmoid table over [-6, 6]
    (init_SM_TABLE, sample/algorithms.cpp:755-763)."""
    i = jnp.arange(SM_TABLE_SIZE, dtype=jnp.float32)
    x = 2.0 * SM_BOUND * i / SM_TABLE_SIZE - SM_BOUND
    return jax.nn.sigmoid(x)


def table_sigmoid(v: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """Table lookup σ̂(v) (fast_SM, sample/algorithms.cpp:765-770).  The
    exact sigmoid is the default; this exists only for bit-level parity
    experiments with the reference."""
    idx = ((v + SM_BOUND) * SM_RESOLUTION).astype(jnp.int32)
    idx = jnp.clip(idx, 0, SM_TABLE_SIZE - 1)
    looked = table[idx]
    return jnp.where(v > SM_BOUND, 1.0, jnp.where(v < -SM_BOUND, 0.0, looked))


# ---------------------------------------------------------------------------
# Edge (attraction) forces: (xi, xj, inv_deg_i, step) -> [.., D] contribution
# accumulated into the source row's batch-local update buffer.
#
# Every force needs one scalar per edge that is a sum over the embedding
# dimension (a squared distance or a dot product).  ``rsum`` performs that
# reduction; the default is a local lane reduction, while a tensor-parallel
# caller (dim sharded over a mesh axis) passes a psum-augmented reduction so
# the same force functions run unchanged under ``shard_map``.
# ---------------------------------------------------------------------------


def _local_rsum(v):
    return jnp.sum(v, axis=-1, keepdims=True)


def _mask1(coeff, mask):
    """Zero the per-pair scalar coefficient where ``mask`` is False.

    ``mask`` broadcasts against the keepdims rsum output ([.., K, 1]).
    Masking the SCALAR (instead of the [.., K, D] force vector) makes the
    padded-slot contribution exactly zero at 1/D the vector-mask cost —
    for every model the force is coeff(a) ⊗ vector, and a zero coeff
    survives the per-component clamp (clamp(0·diff) = 0).  The mask
    selects, so a NaN/inf coefficient in a padded slot stays out."""
    if mask is None:
        return coeff
    return jnp.where(mask, coeff, 0.0)


def _tdist_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # d1 = -2/(1+||xi-xj||²); clamp(d1·diff)·STEP  (algorithms.cpp:598-612).
    # The clamp is omitted because it provably never binds here: for any
    # component c, a = Σ diff² ≥ diff_c², so |d1·diff_c| = 2|diff_c|/(1+a)
    # ≤ 2|diff_c|/(1+diff_c²) ≤ 1 < MAXBOUND — the reference's scale() is
    # an identity on this term (it DOES bind for the repulsion term, which
    # keeps it).  step and mask fold into the per-pair scalar so the only
    # full-width ops are diff, the squared-distance reduce, and one
    # coeff·diff multiply.
    diff = xi - xj
    a = rsum(diff * diff)
    d1 = _mask1(step * -2.0 / (1.0 + a), mask)
    return d1 * diff


def _tdist_exact_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # clamp(d1·diff) - clamp(d2·diff) with d2 = 2/(a(1+a))
    # (algorithms.cpp:378-395)
    diff = xi - xj
    a = rsum(diff * diff)
    d1 = _mask1(-2.0 / (1.0 + a), mask)
    d2 = _mask1(2.0 / (a * (1.0 + a)), mask)
    return step * (_clamp(d1 * diff) - _clamp(d2 * diff))


def _sigmoid_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # STEP · degi · (1-σ(xi·xj)) · xj with degi = 1/(deg_i+1)
    # (algorithms.cpp:854-868)
    a = rsum(xi * xj)
    return step * inv_deg * _mask1(1.0 - jax.nn.sigmoid(a), mask) * xj


def _fr_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # diff = xj - xi; w = a + 1/a if a>0 else 0  (algorithms.cpp:196-211)
    diff = xj - xi
    a = rsum(diff * diff)
    w = jnp.where(a > 0.0, a + 1.0 / jnp.where(a > 0.0, a, 1.0), 0.0)
    return _mask1(w, mask) * diff


def _linlog_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # w = log2(1 + sqrt(a))  (algorithms.cpp:290-303)
    diff = xj - xi
    a = rsum(diff * diff)
    w = jnp.log2(1.0 + jnp.sqrt(a))
    return _mask1(w, mask) * diff


def _forceatlas_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # w = sqrt(a) + 1/a if a>0 else 0  (algorithms.cpp:101-115)
    diff = xj - xi
    a = rsum(diff * diff)
    safe = jnp.where(a > 0.0, a, 1.0)
    w = jnp.where(a > 0.0, jnp.sqrt(safe) + 1.0 / safe, 0.0)
    return _mask1(w, mask) * diff


# ---------------------------------------------------------------------------
# Sample (repulsion) forces: (xi, s, step) -> [.., D] contribution.
# ---------------------------------------------------------------------------


def _tdist_rep(xi, s, step, rsum=_local_rsum, mask=None):
    # d1 = 2/(r(1+r)); STEP·clamp(d1·diff)  (algorithms.cpp:614-627).
    # The reference computes d1 unguarded; it is compiled with -ffast-math
    # (Makefile:10), so a sample coinciding with the vertex (r = 0, which
    # happens whenever a negative sample hits a batch vertex) yields no NaN
    # in practice.  We make the same outcome explicit: the force at r = 0 is
    # directionless, so its contribution is zero.
    diff = xi - s
    r = rsum(diff * diff)
    d1 = jnp.where(r > 0.0, 2.0 / jnp.where(r > 0.0, r * (1.0 + r), 1.0), 0.0)
    return step * _clamp(_mask1(d1, mask) * diff)


def _sigmoid_rep(xi, s, step, rsum=_local_rsum, mask=None):
    # -STEP·σ(xi·s)·s  (algorithms.cpp:898-911)
    r = rsum(xi * s)
    return -step * _mask1(jax.nn.sigmoid(r), mask) * s


def _layout_rep(xi, s, step, rsum=_local_rsum, mask=None):
    # diff = s - xi; -(1/r)·diff, guarded r>0  (algorithms.cpp:117-128)
    diff = s - xi
    r = rsum(diff * diff)
    inv = jnp.where(r > 0.0, 1.0 / jnp.where(r > 0.0, r, 1.0), 0.0)
    return -_mask1(inv, mask) * diff


@dataclasses.dataclass(frozen=True)
class ForceModel:
    """Declarative description of one Force2Vec variant."""

    name: str
    edge_force: Callable  # (xi, xj, inv_deg_i, step) -> [.., D]
    sample_force: Callable  # (xi, s, step) -> [.., D]
    init: str  # 'uniform01' (randInit) | 'symmetric' (randInitF)
    update: str  # 'add' | 'energy'
    lr_schedule: str  # 'constant' | 'decay999'
    default_lr: float  # STEP at iteration 0
    uses_degree: bool = False
    attraction: str = "csr"  # 'csr' | 'walk'
    repulsion: str = "sampled"  # 'sampled' | 'all'
    neg_range: str = "global"  # 'global': [0, n-1) | 'prefix': [0, min((b+1)B, n-1))


FORCE_MODELS = {
    "tdist": ForceModel(
        name="tdist",
        edge_force=_tdist_edge,
        sample_force=_tdist_rep,
        init="symmetric",
        update="add",
        lr_schedule="constant",
        default_lr=0.02,
    ),
    "sigmoid": ForceModel(
        name="sigmoid",
        edge_force=_sigmoid_edge,
        sample_force=_sigmoid_rep,
        init="uniform01",
        update="add",  # reference seeds prev with X then replaces — identical to +=
        lr_schedule="constant",
        default_lr=0.02,
        uses_degree=True,
    ),
    "rwalk": ForceModel(
        name="rwalk",
        edge_force=_sigmoid_edge,
        sample_force=_sigmoid_rep,
        init="uniform01",
        update="add",
        lr_schedule="constant",
        default_lr=0.02,
        uses_degree=True,
        attraction="walk",
        neg_range="prefix",
    ),
    "fr": ForceModel(
        name="fr",
        edge_force=_fr_edge,
        sample_force=_layout_rep,
        init="symmetric",
        update="energy",
        lr_schedule="decay999",
        default_lr=1.0,
    ),
    "linlog": ForceModel(
        name="linlog",
        edge_force=_linlog_edge,
        sample_force=_layout_rep,
        init="symmetric",
        update="energy",
        lr_schedule="decay999",
        default_lr=1.0,
    ),
    "forceatlas": ForceModel(
        name="forceatlas",
        edge_force=_forceatlas_edge,
        sample_force=_layout_rep,
        init="symmetric",
        update="energy",
        lr_schedule="decay999",
        default_lr=1.0,
    ),
    "tdist_exact": ForceModel(
        name="tdist_exact",
        edge_force=_tdist_exact_edge,
        sample_force=_tdist_rep,
        init="symmetric",
        update="add",
        lr_schedule="decay999",
        default_lr=1.0,
        repulsion="all",
    ),
}

_TABLE_MODELS: dict = {}


def with_table_sigmoid(model: ForceModel) -> ForceModel:
    """Variant of a sigmoid-family model whose σ is the reference's
    2048-entry table lookup (fast_SM, sample/algorithms.cpp:755-776) —
    the bit-level parity-experiment mode."""
    if model.edge_force is not _sigmoid_edge:
        raise ValueError(
            f"sm_table applies to the sigmoid family only, not {model.name!r}"
        )
    if model.name in _TABLE_MODELS:
        return _TABLE_MODELS[model.name]
    table = make_sm_table()

    def edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
        a = rsum(xi * xj)
        return step * inv_deg * _mask1(1.0 - table_sigmoid(a, table), mask) * xj

    def rep(xi, s, step, rsum=_local_rsum, mask=None):
        r = rsum(xi * s)
        return -step * _mask1(table_sigmoid(r, table), mask) * s

    out = dataclasses.replace(
        model, name=model.name + "_table", edge_force=edge, sample_force=rep
    )
    _TABLE_MODELS[model.name] = out
    return out


# CLI option-number compatibility (Test/Force2Vec.cpp:129-188). Options
# 8-11 are the reference's AVX512 builds of 5/6/7 — here they are the
# same models (XLA's fused code replaces the intrinsics), so they alias
# their scalar twins.
OPTION_TO_MODEL = {
    1: "tdist_exact",
    2: "fr",
    3: "linlog",
    4: "forceatlas",
    5: "tdist",
    6: "sigmoid",
    7: "rwalk",
    8: "tdist",
    9: "sigmoid",
    10: "rwalk",
    11: "tdist",
}


def get_model(name_or_option, sm_table: bool = False) -> ForceModel:
    """Look up a model by name or by reference CLI option number.

    ``sm_table=True`` swaps the sigmoid family's exact σ for the
    reference's 2048-entry lookup table (fast_SM parity mode)."""
    if isinstance(name_or_option, int):
        name_or_option = OPTION_TO_MODEL[name_or_option]
    model = FORCE_MODELS[name_or_option]
    if sm_table:
        model = with_table_sigmoid(model)
    return model
