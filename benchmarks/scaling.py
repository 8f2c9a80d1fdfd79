"""Scaling-efficiency harness: updates/s at 1..N devices (BASELINE.md).

Runs a distributed trainer over meshes of increasing size on whatever
devices the runtime has — real GPUs, or a virtual CPU mesh
(JAX_PLATFORMS=cpu with --xla_force_host_platform_device_count=N) for
plumbing validation — and records throughput + efficiency vs the
single-device run, plus the per-iteration communication volume
(comm_stats) so exchange cost is a number in the artifact, not an
assertion.

Writes SCALING.json at the repo root; the platform field says whether the
curve ran on real devices or the virtual CPU mesh.

Usage:
    python benchmarks/scaling.py [--n 65536] [--deg 16] [--iters 30]
                                 [--mode sharded|vp] [--tp 1]
                                 [--devices 1,2,4,8] [--out SCALING.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--mode", default="vp", choices=("sharded", "vp"))
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--devices", default="")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--out", default=os.path.join(REPO, "SCALING.json"))
    ap.add_argument("--hot-rows", type=int, default=0,
                    help="sharded mode: rows in the hot/cold gather split's "
                    "hot suffix (composes with dp — each rank sweeps 1/dp "
                    "of every span chunk); 0 = no split")
    ap.add_argument("--structure", default="powerlaw",
                    choices=("powerlaw", "communities"),
                    help="communities: Zipf-sized planted communities under "
                    "the same degree skew (the SNAP com-* family's shape) — "
                    "the partitioner's block deal can then exploit locality, "
                    "which the structureless powerlaw graph makes physically "
                    "impossible (every row is needed by ~all shards)")
    args = ap.parse_args()

    import jax

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        # the config update makes the choice stick even where another
        # backend is registered
        jax.config.update("jax_platforms", "cpu")

    from bench import synth_powerlaw_graph
    from force2vec_tpu.train.trainer import TrainConfig

    avail = len(jax.devices())
    sizes = (
        [int(s) for s in args.devices.split(",") if s]
        if args.devices
        else [s for s in (1, 2, 4, 8, 16, 32) if s <= avail]
    )

    if args.structure == "communities":
        from force2vec_tpu.graphs.csr import Graph

        rng = np.random.default_rng(7)
        n, m = args.n, args.n * args.deg // 2
        w = (np.arange(n, dtype=np.float64) + 1.0) ** -0.5
        w /= w.sum()
        n_comm = max(n // 1000, 1)
        cw = (np.arange(n_comm, dtype=np.float64) + 1.0) ** -0.7
        cw /= cw.sum()
        comm_of = np.sort(rng.choice(n_comm, size=n, p=cw))
        starts = np.searchsorted(comm_of, np.arange(n_comm))
        ends = np.searchsorted(comm_of, np.arange(n_comm), side="right")
        mi = int(m * 0.6)
        si = rng.integers(0, n, size=mi, dtype=np.int64)
        c = comm_of[si]
        span = np.maximum(ends[c] - starts[c], 1)
        di = starts[c] + rng.integers(0, 1 << 62, size=mi) % span
        sg = rng.integers(0, n, size=m - mi, dtype=np.int64)
        dg = rng.choice(n, size=m - mi, p=w).astype(np.int64)
        src = np.concatenate([si, sg])
        dst = np.concatenate([di, dg])
        keep = src != dst
        graph = Graph.from_coo(
            np.concatenate([src[keep], dst[keep]]),
            np.concatenate([dst[keep], src[keep]]), None, n=n)
    else:
        graph = synth_powerlaw_graph(n=args.n, avg_deg=args.deg)
    cfg = TrainConfig(
        dim=args.dim, model="tdist", ns=5, per_vertex_samples=True
    )
    updates = (graph.nnz + graph.n * cfg.ns) * args.iters

    base_rate = None
    rows = []
    for nd in sizes:
        if nd % args.tp:
            continue
        comm = None
        if args.mode == "vp":
            from force2vec_tpu.dist.vertex_sharded import (
                VertexShardedForce2Vec,
                make_vp_mesh,
            )

            runner = VertexShardedForce2Vec(
                graph, cfg, make_vp_mesh(jax.devices()[:nd]),
                min_width=16, hub_width=128, sampling="pool",
            )
            garr, train_jit = runner._garr, runner._train_jit
            x = runner.init_embedding(1)
            comm = {
                k: v
                for k, v in runner.comm_stats().items()
                if k != "layout"
            }
        else:
            from force2vec_tpu.dist.sharded import (
                ShardedSyncForce2Vec,
                make_mesh,
            )

            mesh = make_mesh(jax.devices()[:nd], dp=nd // args.tp, tp=args.tp)
            runner = ShardedSyncForce2Vec(
                graph, cfg, mesh, min_width=16, hub_width=128,
                hot_rows=args.hot_rows,
            )
            if args.hot_rows:
                assert runner.fv.layout.hot_start is not None
                comm = {"gather_split": runner.fv.split_stats()}
            garr, train_jit = runner._garr, runner._train_jit
            x = runner.init_embedding(1)
        key = jax.random.PRNGKey(1)
        x = jax.block_until_ready(train_jit(garr, x, key, args.warmup, 0))
        t0 = time.perf_counter()
        x = jax.block_until_ready(
            train_jit(garr, x, key, args.iters, args.warmup))
        dt = time.perf_counter() - t0
        rate = updates / dt
        if base_rate is None:
            base_rate = rate
        # On a virtual CPU mesh all N devices share one host's cores, so
        # the ideal AGGREGATE rate is flat (= the 1-device rate), and the
        # meaningful number is how much of it survives partitioning +
        # collectives ("retention").  Per-device efficiency rate/(base*N)
        # is only meaningful on real devices.
        is_virtual = jax.devices()[0].platform == "cpu"
        eff_key = "aggregate_retention" if is_virtual else "efficiency"
        eff = rate / base_rate if is_virtual else rate / (base_rate * nd)
        rows.append(
            {
                "devices": nd,
                "mode": args.mode,
                "seconds": round(dt, 4),
                "m_updates_per_s": round(rate / 1e6, 2),
                eff_key: round(eff, 3),
                **({"comm_per_iter_per_shard": comm} if comm else {}),
            }
        )
        print(json.dumps(rows[-1]), flush=True)

    out = {
        "platform": jax.devices()[0].platform,
        "note": (
            "virtual CPU mesh — plumbing/efficiency-shape evidence only"
            if jax.devices()[0].platform == "cpu"
            else f"real devices: {jax.devices()[0].device_kind}"
        ),
        "graph": {"n": graph.n, "nnz": graph.nnz},
        "config": {"dim": args.dim, "model": "tdist", "ns": 5,
                   "iters": args.iters, "mode": args.mode,
                   "structure": args.structure},
        "scaling": rows,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
