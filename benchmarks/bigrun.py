"""Big-graph end-to-end proof: com-Youtube-scale synthetic graph through
native load -> device training -> subsampled link prediction.

Records BIGRUN.json: {graph, load_seconds, layout_seconds, train
updates/s, eval AUC} — the can't-fit-in-networkx regime the reference
handles with performancescores/biglinkprediction.py:133 (evaluate on the
first `size` vertices).

Usage: python benchmarks/bigrun.py [--n 1500000] [--deg 34] [--iters 300]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, ".data")  # generated graphs (gitignored)
sys.path.insert(0, REPO)

import numpy as np


def synth_big(n, avg_deg, seed=7, path=None, structure="powerlaw"):
    """Power-law graph at com-Youtube scale, written as a symmetric .mtx
    (exercises the native mmap+OpenMP parser end-to-end).

    ``structure='communities'`` plants power-law-SIZED communities under
    the same degree skew (60% of stubs close inside the community, 40%
    follow the global power-law): the com-* datasets the reference
    benchmarks are community graphs (SNAP ground-truth-community family),
    and link prediction on a structureless uniform-mixing graph measures
    only degree, which bounds AUC regardless of the embedder."""
    path = path or os.path.join(DATA, "bigrun.mtx")
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    w = (np.arange(n, dtype=np.float64) + 1.0) ** -0.5
    w /= w.sum()
    if structure == "communities":
        # community sizes ~ Zipf over ~n/1000 communities; membership by
        # contiguous id ranges AFTER a global id scramble (so vertex id
        # carries no information, matching arbitrary real-world ids)
        n_comm = max(n // 1000, 1)
        cw = (np.arange(n_comm, dtype=np.float64) + 1.0) ** -0.7
        cw /= cw.sum()
        comm_of = np.sort(rng.choice(n_comm, size=n, p=cw))
        # global scramble: maps "structured id" -> public id
        scramble = rng.permutation(n).astype(np.int64)
        starts = np.searchsorted(comm_of, np.arange(n_comm))
        ends = np.searchsorted(comm_of, np.arange(n_comm), side="right")
        m_intra = int(m * 0.6)
        src_i = rng.integers(0, n, size=m_intra, dtype=np.int64)
        c = comm_of[src_i]
        span = np.maximum(ends[c] - starts[c], 1)
        dst_i = starts[c] + rng.integers(0, 1 << 62, size=m_intra) % span
        src_g = rng.integers(0, n, size=m - m_intra, dtype=np.int64)
        dst_g = rng.choice(n, size=m - m_intra, p=w).astype(np.int64)
        src = scramble[np.concatenate([src_i, src_g])]
        dst = scramble[np.concatenate([dst_i, dst_g])]
    else:
        src = rng.integers(0, n, size=m, dtype=np.int64)
        dst = rng.choice(n, size=m, p=w).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo = np.minimum(src, dst) + 1
    hi = np.maximum(src, dst) + 1
    t0 = time.time()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern symmetric\n")
        f.write(f"{n} {n} {len(lo)}\n")
        chunk = 4_000_000
        for i in range(0, len(lo), chunk):
            np.savetxt(f, np.column_stack([hi[i : i + chunk], lo[i : i + chunk]]),
                       fmt="%d %d")
    print(f"wrote {path} ({len(lo)} upper-tri edges) in {time.time()-t0:.1f}s",
          flush=True)
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_500_000)
    ap.add_argument("--deg", type=int, default=34)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--eval-size", type=int, default=100_000)
    ap.add_argument("--eval-rows", default="first", choices=["first", "random"],
                    help="which vertices the subsampled link-pred uses. The "
                    "reference protocol takes the FIRST `size` vertices "
                    "(performancescores/biglinkprediction.py) of real .mtx "
                    "files whose ids are arbitrary — i.e. effectively a "
                    "random sample.  synth_big assigns low ids to hubs, so "
                    "'first' there selects the top-degree core (whose t-dist "
                    "embedding collapses at high density and reads AUC~0.5 "
                    "regardless of training); 'random' (seeded) is the "
                    "faithful equivalent of the reference protocol on this "
                    "generator.")
    ap.add_argument("--tag", default="", help="artifact suffix: BIGRUN_<tag>.json")
    ap.add_argument("--span", type=int, default=50,
                    help="iterations per device program (progress is "
                    "printed between programs)")
    ap.add_argument("--mtx", default=None,
                    help="graph file to write/reuse (default .data/bigrun.mtx)")
    ap.add_argument("--structure", default="powerlaw",
                    choices=["powerlaw", "communities"])
    ap.add_argument("--model", default="tdist",
                    choices=["tdist", "sigmoid", "rwalk"],
                    help="force model (reference options 5/11, 6/9, 7/10); "
                    "rwalk covers the BASELINE Flickr config")
    ap.add_argument("--lr", type=float, default=None,
                    help="override the model default (reference -lr flag); "
                    "attraction strength scales with avg degree, so dense "
                    "graphs (com-Orkut deg ~78) need a smaller step than "
                    "the deg-34 Youtube config")
    args = ap.parse_args()

    path = synth_big(args.n, args.deg, path=args.mtx,
                     structure=args.structure)
    size_mb = os.path.getsize(path) / 1e6

    from force2vec_tpu.graphs import io as gio
    from force2vec_tpu.graphs.io import load_graph

    t0 = time.perf_counter()
    graph = load_graph(path)
    load_s = time.perf_counter() - t0
    # which parser actually ran — an artifact must never silently claim
    # native-parser load numbers
    print(f"load [{gio.last_parser} parser]: n={graph.n} nnz={graph.nnz} "
          f"in {load_s:.2f}s ({size_mb:.0f} MB .mtx)", flush=True)

    import jax

    from force2vec_tpu.train.sync import SyncForce2Vec
    from force2vec_tpu.train.trainer import TrainConfig

    cfg = TrainConfig(dim=128, model=args.model, ns=5, batch_size=256,
                      gather_dtype="bfloat16", lr=args.lr)
    t0 = time.perf_counter()
    fv = SyncForce2Vec(graph, cfg, min_width=8, hub_width=128)
    layout_s = time.perf_counter() - t0
    split = fv.split_stats()
    print(f"layout build: {layout_s:.2f}s padded_edges={fv.layout.padded_edges} "
          f"split={split}", flush=True)

    x = fv.init_embedding(seed=1)
    key = jax.random.PRNGKey(1)
    span = min(args.span, args.iters)
    # warmup with the SAME span length as the timed spans: the train entry
    # compiles one program per iteration count, and a shorter warmup span
    # would leave the real compile inside the timed region.
    x = jax.block_until_ready(fv._train_jit(fv._garr, x, key, span, 0))
    t0 = time.perf_counter()
    done = span
    while done < args.iters:
        k = min(span, args.iters - done)
        x = fv._train_jit(fv._garr, x, key, k, done)
        done += k
    jax.block_until_ready(x)
    train_s = time.perf_counter() - t0
    train_s *= args.iters / max(args.iters - span, 1)  # scale for warmup span
    upd_per_iter = (
        graph.n * cfg.walk_length if args.model == "rwalk" else graph.nnz
    ) + graph.n * cfg.ns
    ups = upd_per_iter * args.iters / train_s
    print(f"train: {args.iters} iters in {train_s:.1f}s = {ups/1e6:.1f} M updates/s",
          flush=True)

    # subsampled link prediction (reference: biglinkprediction.py evaluates
    # on the first `size` vertices).  Fetch ONLY the eval rows: the rest of
    # the table never reaches the host.
    from force2vec_tpu.eval.linkpred import link_prediction_scores

    t0 = time.perf_counter()
    import jax.numpy as jnp

    if args.eval_rows == "random":
        sub_nodes = np.sort(np.random.default_rng(12345).choice(
            graph.n, size=args.eval_size, replace=False))
    else:
        sub_nodes = np.arange(args.eval_size)
    idx_rel = jnp.asarray(
        fv.layout.inv_perm[sub_nodes], dtype=jnp.int32)
    emb_sub = np.asarray(
        jax.jit(lambda x, i: jnp.take(x, i, axis=0))(x, idx_rel))
    fetch_s = time.perf_counter() - t0
    print(f"eval-row fetch [{args.eval_rows}]: {fetch_s:.1f}s "
          f"({emb_sub.nbytes/1e6:.0f} MB)", flush=True)
    t0 = time.perf_counter()
    sub = graph.induced_subgraph(sub_nodes)
    scores = link_prediction_scores(sub, emb_sub, seed=0)
    eval_s = time.perf_counter() - t0
    print(f"eval (first {args.eval_size} nodes, {sub.nnz} edges): {scores} "
          f"in {eval_s:.1f}s", flush=True)

    out = {
        "graph": {"n": graph.n, "nnz": graph.nnz, "mtx_mb": round(size_mb, 1)},
        "parser": gio.last_parser,
        "load_seconds": round(load_s, 2),
        "layout_seconds": round(layout_s, 2),
        "gather_split": split,
        "train": {
            "iters": args.iters,
            "seconds": round(train_s, 2),
            "m_updates_per_s": round(ups / 1e6, 2),
            "schedule": "sync",
            "dim": 128,
            "model": args.model,
            "lr": cfg.resolve_lr(fv.model),
            "structure": args.structure,
        },
        "eval": {"subsample": args.eval_size, "rows": args.eval_rows,
                 **{k: round(v, 4) for k, v in scores.items()}},
    }
    name = f"BIGRUN_{args.tag}.json" if args.tag else "BIGRUN.json"
    with open(os.path.join(REPO, name), "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {name}", flush=True)


if __name__ == "__main__":
    main()
