"""Smoke run of the training path on an NVIDIA GPU.

    python chip_smoke.py            # one card: CLI, sync models, parity, quality
    python chip_smoke.py --cards 4  # four cards: the multi-device runners only

One card drives the main path through the entry points a user calls, at
full width (dim 128, ns 5) on the bench graph (``bench.synth_powerlaw_graph``,
n = 131,072, nnz ~ 2.1 M):

* ``cli``: ``force2vec_tpu.cli.main`` in-process, ``--schedule sync
  --gather-dtype bfloat16`` and the default batch schedule, each writing
  its ``.embd``;
* ``sync_<model>``: ``SyncForce2Vec`` for tdist, sigmoid and rwalk with the
  bf16 gather replica — compile seconds, ms/iter, ``memory_analysis()`` of
  the sync step;
* ``parity``: one sync iteration with injected negatives and walks against
  the numpy oracle (``models/reference_impl.run_reference``) for every
  sampled-repulsion model at D=128 on a power-law graph with hub virtual
  rows; f32 gathers within 3e-4 (rtol and atol; the bound covers the GPU's
  summation order), the bf16 replica within 6e-3 of the f32 path;
* ``quality``: a few hundred iterations on a seeded planted-partition graph;
  the edge-vs-random-pair distance AUC must reach ``AUC_FLOOR``.

``--cards 4`` runs the dp-sharded sync runner, the vertex-sharded runner
(vp=4) and the dp-sharded batch runner on the bench graph, each against the
one-card result at the same seed, and checks that the sharded runners hold
their graph arrays replicated on the mesh.

Each phase prints ``phase <name> ok|fail {...}``; the card's name and power
limit come before the last line, which is one JSON object.  With no GPU, or
when any phase fails, the script exits non-zero and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".data", "smoke")

BENCH_N, BENCH_DEG = 131072, 16
DIM, NS = 128, 5
# edge-vs-random distance AUC after 300 iterations on the planted-partition
# graph below (seed 3); a CPU run of the same code reads 0.911, and the
# floor leaves 0.03 for the GPU's other summation order and bf16 gathers
AUC_FLOOR = 0.88
F32_TOL = 3e-4  # as tests/test_sync.py
BF16_TOL = 6e-3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def write_mtx(graph, path: str) -> None:
    """Symmetric pattern MatrixMarket file of ``graph`` (one entry per
    undirected edge)."""
    src = np.repeat(np.arange(graph.n), graph.degrees)
    keep = src > graph.colids
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern symmetric\n")
        f.write(f"{graph.n} {graph.n} {int(keep.sum())}\n")
        np.savetxt(f, np.column_stack([src[keep] + 1, graph.colids[keep] + 1]),
                   fmt="%d %d")


def check_embd(path: str, n: int, dim: int) -> None:
    with open(path) as f:
        head = f.readline().split()
        rows = sum(1 for _ in f)
    if head[:2] != [str(n), str(dim)] or rows != n:
        raise AssertionError(f"{path}: header {head}, {rows} rows")


def phase_cli(mtx: str, out_dir: str, schedule: str, iters: int,
              dim: int = DIM) -> dict:
    """The CLI in-process; ``schedule`` is 'sync' (bf16 replica) or the
    default batch schedule."""
    from force2vec_tpu import cli
    from force2vec_tpu.graphs import read_mtx

    args = ["-input", mtx, "-output", out_dir, "-iter", str(iters),
            "-dim", str(dim), "-option", "5"]
    if schedule == "sync":
        args += ["--schedule", "sync", "--gather-dtype", "bfloat16"]
    t0 = time.perf_counter()
    rc = cli.main(args)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli exit {rc}")
    embd = [f for f in os.listdir(out_dir) if f.endswith(".embd")]
    if len(embd) != 1:
        raise AssertionError(f"expected one .embd in {out_dir}, got {embd}")
    check_embd(os.path.join(out_dir, embd[0]), read_mtx(mtx).n, dim)
    return {"schedule": schedule, "iters": iters, "wall_s": wall,
            "embd": embd[0]}


def _memory(ma) -> dict:
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def phase_sync(graph, model: str, iters: int, out_dir: str,
               dim: int = DIM) -> dict:
    """``SyncForce2Vec`` as the CLI builds it, with the bf16 replica."""
    import jax
    import jax.numpy as jnp

    from force2vec_tpu.graphs.io import write_embeddings
    from force2vec_tpu.train.sync import SyncForce2Vec
    from force2vec_tpu.train.trainer import TrainConfig

    cfg = TrainConfig(dim=dim, model=model, ns=NS, batch_size=256,
                      gather_dtype="bfloat16")
    t0 = time.perf_counter()
    fv = SyncForce2Vec(graph, cfg)
    layout_s = time.perf_counter() - t0
    x0 = fv.init_embedding(seed=1)
    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    x = jax.block_until_ready(fv._train_jit(fv._garr, x0, key, iters, 0))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = jax.block_until_ready(fv._train_jit(fv._garr, x, key, iters, iters))
    run_s = time.perf_counter() - t0
    emb = fv.unpad_embedding(x)
    if emb.shape != (graph.n, dim) or not np.isfinite(emb).all():
        raise AssertionError(f"bad embedding {emb.shape}")
    path = os.path.join(out_dir, f"sync_{model}.embd")
    write_embeddings(path, emb)
    check_embd(path, graph.n, dim)

    lay = fv.layout
    ng = -(-lay.n_pad // cfg.batch_size)
    negs = jnp.zeros((ng, NS), jnp.int32)
    walks = (jnp.zeros((lay.n_pad, cfg.walk_length), jnp.int32)
             if fv.model.attraction == "walk" else None)
    step_mem = jax.jit(fv._iteration).lower(
        fv._garr, x0, negs, walks, jnp.float32(fv.lr)).compile().memory_analysis()
    updates = ((graph.n * cfg.walk_length if model == "rwalk" else graph.nnz)
               + graph.n * NS)
    ms_iter = run_s / iters * 1e3
    return {"model": model, "iters": 2 * iters, "layout_s": layout_s,
            "compile_s": first_s - run_s, "ms_iter": ms_iter,
            "m_updates_per_s": updates / ms_iter / 1e3,
            "step_memory": _memory(step_mem)}


def phase_parity(n: int = 3000, dim: int = DIM, hub_width: int = 64,
                 models=("tdist", "sigmoid", "rwalk", "fr", "linlog",
                         "forceatlas")) -> dict:
    """One sync iteration against the numpy oracle, f32 and bf16 gathers."""
    import jax

    from bench import synth_powerlaw_graph
    from force2vec_tpu.models.reference_impl import run_reference
    from force2vec_tpu.train.sync import SyncForce2Vec
    from force2vec_tpu.train.trainer import TrainConfig

    graph = synth_powerlaw_graph(n=n, avg_deg=16, seed=5)
    out = {"n": graph.n, "nnz": graph.nnz, "max_deg": int(graph.degrees.max())}
    for model in models:
        rng = np.random.default_rng(7)
        lo = 0.0 if model in ("sigmoid", "rwalk") else -1.0
        x0 = rng.uniform(lo, 1.0, (n, dim)).astype(np.float32)
        # the reference's -bs 1 per-vertex flavour where it has one
        per_vertex = model in ("tdist", "sigmoid", "rwalk")
        fvs = {}
        for gd in (None, "bfloat16"):
            cfg = TrainConfig(dim=dim, batch_size=n, model=model, ns=NS,
                              per_vertex_samples=per_vertex, gather_dtype=gd)
            fvs[gd] = SyncForce2Vec(graph, cfg, min_width=8,
                                    hub_width=hub_width)
        fv = fvs[None]
        lay = fv.layout
        if not any(b.owners is not None for b in lay.buckets):
            raise AssertionError("parity graph has no hub virtual rows")
        buf = rng.integers(0, n - 1, size=(1, 1, NS * n if per_vertex else NS)
                           ).astype(np.int32)
        neg_orig = (buf[0, 0][np.arange(n)[:, None] + np.arange(NS)[None, :]]
                    if per_vertex else np.broadcast_to(buf[0, 0], (n, NS)))
        negs = np.zeros((lay.n_pad, NS), np.int32)
        negs[:n] = lay.inv_perm[neg_orig][lay.perm]
        walks = w = None
        if model == "rwalk":
            walks = rng.integers(0, n, size=(1, n, 5)).astype(np.int32)
            w = np.zeros((lay.n_pad, 5), np.int32)
            w[:n] = lay.inv_perm[walks[0][lay.perm]]
        x_ref = run_reference(graph, x0, model, 1, n, fv.lr, buf,
                              per_vertex=per_vertex, walks=walks)
        got = {}
        for gd, f in fvs.items():
            step = jax.jit(f._iteration)
            got[gd] = f.unpad_embedding(step(
                f._garr, f.pad_embedding(x0), negs,
                None if w is None else w, np.float32(f.lr)))
        err = float(np.max(np.abs(got[None] - x_ref)))
        err16 = float(np.max(np.abs(got["bfloat16"] - got[None])))
        out[model] = {"f32_vs_oracle": err, "bf16_vs_f32": err16}
        np.testing.assert_allclose(got[None], x_ref, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=model)
        if not err16 <= BF16_TOL:
            raise AssertionError(f"{model}: bf16 replica off by {err16}")
    return out


def planted_partition(n: int, blocks: int, p_in: float, p_out: float,
                      seed: int):
    from force2vec_tpu.graphs.csr import Graph

    rng = np.random.default_rng(seed)
    block = np.arange(n) * blocks // n
    p = np.where(block[:, None] == block[None, :], p_in, p_out)
    a = np.triu(rng.random((n, n)) < p, k=1)
    r, c = np.nonzero(a)
    return Graph.from_coo(np.concatenate([r, c]), np.concatenate([c, r]),
                          None, n=n)


def distance_auc(graph, emb: np.ndarray, seed: int = 0) -> float:
    """AUC of -distance separating edges from uniformly random pairs
    (Mann-Whitney rank statistic)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(graph.n), graph.degrees)
    pos = src < graph.colids
    pu, pv = src[pos], graph.colids[pos]
    nu = rng.integers(0, graph.n, pu.size)
    nv = rng.integers(0, graph.n, pu.size)
    d_pos = np.linalg.norm(emb[pu] - emb[pv], axis=1)
    d_neg = np.linalg.norm(emb[nu] - emb[nv], axis=1)
    scores = -np.concatenate([d_pos, d_neg])
    ranks = np.empty(scores.size)
    ranks[np.argsort(scores, kind="stable")] = np.arange(1, scores.size + 1)
    n_pos = d_pos.size
    return float((ranks[:n_pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * d_neg.size))


def phase_quality(n: int = 2000, iters: int = 300, dim: int = DIM,
                  floor: float = AUC_FLOOR) -> dict:
    from force2vec_tpu.train.sync import SyncForce2Vec
    from force2vec_tpu.train.trainer import TrainConfig

    graph = planted_partition(n, blocks=10, p_in=0.05, p_out=0.002, seed=3)
    cfg = TrainConfig(dim=dim, model="tdist", ns=NS, batch_size=256,
                      gather_dtype="bfloat16")
    emb = SyncForce2Vec(graph, cfg).train(iters=iters, seed=1)
    auc = distance_auc(graph, emb)
    if not auc >= floor:
        raise AssertionError(f"AUC {auc} below {floor}")
    return {"n": graph.n, "nnz": graph.nnz, "iters": iters, "auc": auc,
            "floor": floor}


def _replicated(runner, mesh) -> bool:
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    return all(v.sharding.is_equivalent_to(rep, v.ndim)
               for v in runner._garr.values())


def phase_dp_sync(graph, iters: int, n_dev: int = 4) -> dict:
    import jax

    from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec, make_mesh
    from force2vec_tpu.train.sync import SyncForce2Vec
    from force2vec_tpu.train.trainer import TrainConfig

    cfg = TrainConfig(dim=DIM, model="tdist", ns=NS, batch_size=256,
                      gather_dtype="bfloat16")
    want = SyncForce2Vec(graph, cfg).train(iters=iters, seed=1)
    mesh = make_mesh(jax.devices()[:n_dev], dp=n_dev, tp=1)
    runner = ShardedSyncForce2Vec(graph, cfg, mesh)
    t0 = time.perf_counter()
    got = runner.train(iters=iters, seed=1)
    wall = time.perf_counter() - t0
    if not _replicated(runner, mesh):
        raise AssertionError("graph arrays are not held replicated on the mesh")
    err = float(np.max(np.abs(got - want)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)  # test_sharded
    return {"dp": n_dev, "iters": iters, "max_err": err, "wall_s": wall}


def phase_vp(graph, iters: int, n_dev: int = 4) -> dict:
    import jax

    from force2vec_tpu.dist.vertex_sharded import (VertexShardedForce2Vec,
                                                   make_vp_mesh)
    from force2vec_tpu.train.sync import SyncForce2Vec
    from force2vec_tpu.train.trainer import TrainConfig

    cfg = TrainConfig(dim=DIM, model="tdist", ns=NS)
    one = SyncForce2Vec(graph, cfg)
    vfv = VertexShardedForce2Vec(graph, cfg,
                                 mesh=make_vp_mesh(jax.devices()[:n_dev]))
    rng = np.random.default_rng(7)
    x_host = rng.standard_normal((graph.n, DIM)).astype(np.float32) * 0.1
    step_one = jax.jit(one._iteration)
    t0 = time.perf_counter()
    errs = []
    # Each step starts both runners from the same state: the two reduce
    # hub partials in different orders, and over several steps the
    # training dynamics amplify that last-bit difference, which is not a
    # fault of either runner.
    for _ in range(iters):
        pool = rng.integers(0, graph.n - 1, size=NS).astype(np.int32)
        want = one.unpad_embedding(step_one(
            one._garr, one.pad_embedding(x_host),
            np.broadcast_to(pool, (one.layout.n_pad, NS)), None,
            np.float32(one.lr)))
        got = vfv.unpad_embedding(
            vfv.run_iteration(vfv.pad_embedding(x_host), pool))
        errs.append(float(np.max(np.abs(got - want))))
        # as tests/test_vertex_sharded.py
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        x_host = want
    wall = time.perf_counter() - t0
    return {"vp": n_dev, "steps": iters, "max_err_per_step": errs,
            "wall_s": wall}


def phase_dp_batch(graph, iters: int, n_dev: int = 4) -> dict:
    import jax

    from force2vec_tpu.dist import ShardedForce2Vec, make_mesh
    from force2vec_tpu.train.trainer import Force2Vec, TrainConfig

    cfg = TrainConfig(dim=DIM, model="tdist", ns=NS, batch_size=256)
    want = Force2Vec(graph, cfg).train(iters=iters, seed=1)
    mesh = make_mesh(jax.devices()[:n_dev], dp=n_dev, tp=1)
    runner = ShardedForce2Vec(Force2Vec(graph, cfg), mesh)
    t0 = time.perf_counter()
    got = runner.train(iters=iters, seed=1)
    wall = time.perf_counter() - t0
    if not _replicated(runner, mesh):
        raise AssertionError("graph arrays are not held replicated on the mesh")
    err = float(np.max(np.abs(got - want)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)  # test_sharded
    return {"dp": n_dev, "iters": iters, "max_err": err, "wall_s": wall}


def run_phases(phases) -> bool:
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            info = fn()
        except Exception:  # report every phase, then fail the run
            ok = False
            print(f"phase {name} fail {time.perf_counter() - t0:.1f}s\n"
                  f"{traceback.format_exc()}", flush=True)
            continue
        info["phase_s"] = time.perf_counter() - t0
        print(f"phase {name} ok {json.dumps(info)}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    from bench import synth_powerlaw_graph
    from force2vec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < args.cards:
        print(f"error: needs {args.cards} GPU(s); JAX found "
              f"{[d.platform for d in devices]}", file=sys.stderr)
        return 2
    card = card_line()
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    graph = synth_powerlaw_graph(n=BENCH_N, avg_deg=BENCH_DEG)
    print(f"bench graph n={graph.n} nnz={graph.nnz} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)

    if args.cards == 4:
        phases = [
            ("dp_sync", lambda: phase_dp_sync(graph, iters=3)),
            ("vp", lambda: phase_vp(graph, iters=3)),
            ("dp_batch", lambda: phase_dp_batch(graph, iters=2)),
        ]
    else:
        mtx = os.path.join(WORK, "bench.mtx")
        write_mtx(graph, mtx)

        def cli_phase(schedule):
            out = os.path.join(WORK, f"cli_{schedule}")
            if os.path.isdir(out):
                for f in os.listdir(out):
                    os.remove(os.path.join(out, f))
            return phase_cli(mtx, out, schedule, iters=30)

        phases = [("cli_sync", lambda: cli_phase("sync")),
                  ("cli_batch", lambda: cli_phase("batch"))]
        phases += [(f"sync_{m}", lambda m=m: phase_sync(graph, m, 30, WORK))
                   for m in ("tdist", "sigmoid", "rwalk")]
        phases += [("parity", phase_parity), ("quality", phase_quality)]

    ok = run_phases(phases)
    print(f"card: {card}", flush=True)
    if not ok:
        print("error: a phase failed", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
