"""Command-line driver with reference flag parity.

Mirrors the reference CLI (Test/Force2Vec.cpp:49-116): ``-input -output
-batch -iter -threads -dim -nsamples -lr -gamma -bs -option``, same
defaults (batch 256, iter 1200, dim 128, ns 5, lr 0.02 — Test/
Force2Vec.cpp:50-53).  ``-option`` keeps the reference numbering
(models/forces.OPTION_TO_MODEL); ``-threads`` is accepted and ignored
(XLA schedules the device work), ``-gamma`` is accepted and unused
exactly like the reference (parsed at Test/Force2Vec.cpp:76, never read by
kernels).  Additional ``--``-style flags expose what the reference lacks:
checkpointing, evaluation, sharding.

Run summaries append to ``Results.txt`` with the reference's ledger schema
(Test/Force2Vec.cpp:191-198).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="force2vec",
        description="Force2Vec in JAX: force-directed graph embedding",
    )
    # reference-parity flags (single dash, like the C++ driver)
    p.add_argument("-input", required=True, help=".mtx/.bcsr/edgelist graph")
    p.add_argument("-output", default="", help="output directory/prefix")
    p.add_argument("-batch", type=int, default=256)
    p.add_argument("-iter", type=int, default=1200)
    p.add_argument("-threads", type=int, default=0, help="accepted and ignored (parity)")
    p.add_argument("-dim", type=int, default=128)
    p.add_argument("-nsamples", type=int, default=5)
    p.add_argument("-lr", type=float, default=None)
    p.add_argument("-gamma", type=float, default=1.0, help="parsed, unused (parity)")
    p.add_argument("-bs", type=int, default=0, help="1 = per-vertex negative samples")
    p.add_argument("-option", type=int, default=5, help="algorithm variant 1-11")
    # framework extensions
    p.add_argument("--model", default=None, help="model name (overrides -option)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--checkpoint-every", type=int, default=0, help="iters between checkpoints")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--resume", default="", help="checkpoint file to resume from")
    p.add_argument("--eval", action="store_true", help="run link-pred after training")
    p.add_argument("--labels", default="", help="node labels file for eval")
    p.add_argument("--devices", type=int, default=0, help="shard over N devices (dp)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel width")
    p.add_argument(
        "--schedule",
        choices=["batch", "sync", "vertex"],
        default="batch",
        help="batch: reference batch-sequential semantics; sync: epoch-"
        "synchronous throughput schedule (= reference at batch_size=n); "
        "vertex: X vertex-sharded over all devices with halo exchange "
        "(scale-out mode for tables beyond one chip's HBM)",
    )
    p.add_argument(
        "--gather-dtype",
        default=None,
        help="low-precision replica dtype for neighbor gathers (e.g. "
        "bfloat16) — halves HBM gather traffic; implemented on the sync "
        "schedule (a warning is printed if another schedule ignores it)",
    )
    p.add_argument(
        "--neg-pool",
        type=int,
        default=128,
        help="vertex schedule: global negative-sample pool size used when "
        "-bs 1 requests per-vertex negatives",
    )
    p.add_argument(
        "--halo-stale",
        action="store_true",
        help="vertex schedule: iteration-pipelined halo exchange — consume "
        "the buffers exchanged at the previous iteration so the in-flight "
        "collective has no same-iteration consumer (one-iteration-stale "
        "neighbor rows; the reference's own cross-batch semantics)",
    )
    p.add_argument(
        "--coordinator",
        default=None,
        help="multi-host: coordinator address host:port (or set "
        "JAX_COORDINATOR_ADDRESS); single-process when unset",
    )
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's rank")
    p.add_argument(
        "--sm-table",
        action="store_true",
        help="sigmoid family: evaluate σ via the reference's 2048-entry "
        "lookup table (fast_SM parity mode, sample/algorithms.cpp:755-776) "
        "instead of the exact sigmoid",
    )
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.eval:
        from force2vec_tpu.eval.linkpred import require_sklearn

        try:
            require_sklearn()
        except ImportError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    from force2vec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from force2vec_tpu.graphs.io import load_graph, write_embeddings
    from force2vec_tpu.train.trainer import Force2Vec, TrainConfig

    # Multi-host bootstrap FIRST (before any jax.devices() call): joins
    # this process into one JAX runtime spanning every host.  No-op when
    # single-process, so the multi-host story is reachable from the CLI,
    # not only from hand-written launch scripts.
    from force2vec_tpu.dist.multihost import initialize, is_coordinator

    initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    graph = load_graph(args.input)
    model = args.model or args.option
    cfg = TrainConfig(
        dim=args.dim,
        batch_size=args.batch,
        model=model,
        ns=args.nsamples,
        lr=args.lr,
        per_vertex_samples=(args.bs == 1),
        gather_dtype=args.gather_dtype,
        sm_table=args.sm_table,
    )
    # The batch-path runner is only constructed when the batch schedule is
    # selected — its __init__ pushes rowptr/colids/edge_src to the device,
    # which at com-Orkut scale is ~2 GB of duplicate HBM for nothing when
    # --schedule sync|vertex builds its own layout.
    from force2vec_tpu.models.forces import get_model

    model_obj = get_model(model, sm_table=args.sm_table)
    batch_display = min(cfg.batch_size, graph.n)
    print(
        f"graph {args.input}: n={graph.n} nnz={graph.nnz}; model={model_obj.name} "
        f"dim={cfg.dim} batch={batch_display} ns={cfg.ns} "
        f"lr={cfg.resolve_lr(model_obj)}"
    )

    if args.gather_dtype and args.schedule != "sync":
        print(
            f"warning: --gather-dtype is implemented on the sync schedule; "
            f"schedule={args.schedule!r} ignores it",
            file=sys.stderr,
        )

    x0 = None
    start_iter = 0
    if args.resume:
        from force2vec_tpu.train.checkpoint import load_checkpoint

        x0, start_iter = load_checkpoint(args.resume)
        print(f"resumed from {args.resume} at iteration {start_iter}")

    # Build the schedule runner.  Every runner speaks the same protocol
    # (_train_jit / pad / init / unpad), so checkpointing and resume work
    # uniformly across schedules.
    if args.schedule == "vertex":
        import jax

        from force2vec_tpu.dist.vertex_sharded import (
            VertexShardedForce2Vec,
            make_vp_mesh,
        )

        devs = jax.devices()[: args.devices] if args.devices > 0 else None
        # -bs 1 (per-vertex negatives) maps to the pool sampling mode — the
        # static-shape scale-out flavor of per-vertex sampling
        sampling = "pool" if args.bs == 1 else "shared"
        runner = VertexShardedForce2Vec(
            graph, cfg, mesh=make_vp_mesh(devs), sampling=sampling,
            neg_pool=args.neg_pool, halo_stale=args.halo_stale,
        )
    elif args.devices > 1:
        import jax

        from force2vec_tpu.dist import ShardedForce2Vec, make_mesh

        mesh = make_mesh(jax.devices()[: args.devices], tp=args.tp)
        if args.schedule == "sync":
            from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec

            runner = ShardedSyncForce2Vec(graph, cfg, mesh)
        else:
            runner = ShardedForce2Vec(Force2Vec(graph, cfg), mesh)
    elif args.schedule == "sync":
        from force2vec_tpu.train.sync import SyncForce2Vec

        runner = SyncForce2Vec(graph, cfg)
    else:
        runner = Force2Vec(graph, cfg)

    t0 = time.perf_counter()
    if args.checkpoint_every > 0 or args.resume:
        from force2vec_tpu.train.checkpoint import train_with_checkpoints

        emb = train_with_checkpoints(
            runner,
            iters=args.iter,
            seed=args.seed,
            x0=x0,
            start_iter=start_iter,
            every=args.checkpoint_every or args.iter,
            ckpt_dir=args.checkpoint_dir or (args.output or "."),
            verbose=args.verbose,
        )
    else:
        import inspect

        kw = {}
        if "verbose" in inspect.signature(runner.train).parameters:
            kw["verbose"] = args.verbose
        emb = runner.train(args.iter, seed=args.seed, x0=x0, **kw)
    train_s = time.perf_counter() - t0

    if not is_coordinator():
        return 0  # multi-host: only rank 0 writes output/ledger/eval

    # output name parity: <graph><ALGO><B>D<D>IT<it>NS<ns>.embd
    # (algorithms.cpp:650; writeToFile, algorithms.h:118-136)
    base = os.path.basename(args.input)
    tag = f"F2V{model_obj.name.upper()}{batch_display}D{cfg.dim}IT{args.iter}NS{cfg.ns}"
    out_dir = args.output or "."
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, base + tag + ".embd")
    write_embeddings(out_path, emb)
    print(f"wrote {out_path}  ({train_s:.2f}s, "
          f"{graph.nnz * args.iter / max(train_s, 1e-9) / 1e6:.1f}M edge-updates/s)")

    # Results.txt ledger row (Test/Force2Vec.cpp:191-198 schema)
    with open(os.path.join(out_dir, "Results.txt"), "a") as f:
        f.write(
            f"{model_obj.name}\tInit\tIteration:{args.iter}\t"
            f"Numofthreads:{args.threads}\tBatchSize:{batch_display}\t"
            f"Dimension:{cfg.dim}\tTime(sec.):{train_s:.4f}\n"
        )

    if args.eval:
        from force2vec_tpu.eval import link_prediction_scores

        scores = link_prediction_scores(graph, emb)
        print(
            "Link prediction (Hadamard): "
            + " ".join(f"{k}={v:.4f}" for k, v in scores.items())
        )
        if args.labels:
            from force2vec_tpu.eval import node_classification_scores, read_node_labels

            labels = read_node_labels(args.labels, graph.n)
            for tf, sc in node_classification_scores(emb, labels).items():
                print(
                    f"Multilabel-classification {tf:.0%}: "
                    f"F1-macro={sc['f1_macro']:.4f} F1-micro={sc['f1_micro']:.4f}"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
