"""Round benchmark: edge force-updates/s on one GPU, flagship config.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

Config mirrors BASELINE.json's headline metric — tForce2Vec (t-dist +
negative sampling, reference option 5) at dim=128 — on a deterministic
synthetic power-law graph.  An
edge force-update is one endpoint update from either an attraction edge
(nnz per iteration) or a sampled repulsion pair (n·ns per iteration),
i.e. exactly the unit of the reference's inner loops
(sample/algorithms.cpp:598-627).

Timing: one compiled training span is warmed up (compiling it), then run
``BENCH_REPS`` times, each ending in ``jax.block_until_ready``; the best
run gives seconds per iteration.  The benchmark runs only on a GPU and
prints the device it measured.

``vs_baseline`` divides by the reference C++ AVX512 build (option 11, its
fastest configuration) linearly extrapolated to the BASELINE.json
32-thread target from the per-thread rate measured on a 2-core host
(baselines/cpu_reference.json).  Linear extrapolation OVERSTATES a real
32-thread memory-bound CPU, so vs_baseline is a conservative LOWER bound;
the measured-host ratio is printed alongside on stderr.
"""

import json
import os
import sys
import time

import numpy as np


def synth_powerlaw_graph(n=131072, avg_deg=16, seed=42):
    """Deterministic preferential-attachment-flavored graph: each vertex
    draws `avg_deg/2` endpoints with probability ∝ (rank+1)^-0.5, then the
    edge set is symmetrized. Gives a heavy-tailed degree distribution like
    the reference's com-* configs."""
    from force2vec_tpu.graphs.csr import Graph

    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    # power-law target distribution over vertex ranks
    w = (np.arange(n, dtype=np.float64) + 1.0) ** -0.5
    w /= w.sum()
    src = rng.integers(0, n, size=m)
    dst = rng.choice(n, size=m, p=w)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    return Graph.from_coo(rows, cols, None, n=n)


def card_power_limit() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def main():
    t0 = time.time()
    import jax

    from force2vec_tpu.train.sync import SyncForce2Vec
    from force2vec_tpu.train.trainer import TrainConfig
    from force2vec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    card = card_power_limit()

    n = int(os.environ.get("BENCH_N", 131072))
    avg_deg = int(os.environ.get("BENCH_DEG", 16))
    iters = int(os.environ.get("BENCH_ITERS", 200))
    reps = int(os.environ.get("BENCH_REPS", 3))

    graph = synth_powerlaw_graph(n=n, avg_deg=avg_deg)
    # bf16 gather replica by default.  This EXACT configuration (sync +
    # 256-row group-shared negatives + bf16 gathers) is golden-gated in
    # tests/test_golden.py::test_bench_config_quality_gate, and grouped
    # negatives are oracle-parity-tested in
    # tests/test_sync.py::test_sync_grouped_negatives_match_expanded.
    # BENCH_GATHER_DTYPE=float32 opts out.
    gather_dtype = os.environ.get("BENCH_GATHER_DTYPE", "bfloat16")
    if gather_dtype in ("", "none", "float32"):
        gather_dtype = None
    # batch-shared negatives per 256-row group — the reference's own
    # option-5 sampling pattern (sample/algorithms.cpp:577-586);
    # BENCH_PER_VERTEX=1 switches to the -bs 1 per-vertex flavor.
    per_vertex = os.environ.get("BENCH_PER_VERTEX", "") == "1"
    # BENCH_MODEL=tdist|sigmoid|rwalk: the three throughput-relevant force
    # families (reference options 5/11, 6/9, 7/10); tdist is the headline.
    bench_model = os.environ.get("BENCH_MODEL", "tdist")
    cfg = TrainConfig(
        dim=128, model=bench_model, ns=5, batch_size=256,
        per_vertex_samples=per_vertex, gather_dtype=gather_dtype,
    )
    fv = SyncForce2Vec(graph, cfg, min_width=8, hub_width=128)

    x = fv.init_embedding(seed=1)
    key = jax.random.PRNGKey(1)
    t1 = time.perf_counter()
    jax.block_until_ready(fv._train_jit(fv._garr, x, key, iters, 0))
    first_s = time.perf_counter() - t1
    best = float("inf")
    for _ in range(reps):
        t1 = time.perf_counter()
        jax.block_until_ready(fv._train_jit(fv._garr, x, key, iters, iters))
        best = min(best, time.perf_counter() - t1)
    sec_per_iter = best / iters

    updates_per_iter = (
        graph.n * cfg.walk_length if bench_model == "rwalk" else graph.nnz
    ) + graph.n * cfg.ns
    mups = updates_per_iter / sec_per_iter / 1e6

    # Baseline: the linearly-extrapolated 32-thread AVX512 number — an
    # UPPER bound on the CPU (see baselines/cpu_reference.json), so
    # vs_baseline is a lower bound on the true ratio, per BASELINE.json's
    # ">=5x vs 32-thread" north star.
    vs = vs_host = vs_real = None
    base_path = os.path.join(os.path.dirname(__file__), "baselines",
                             "cpu_reference.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
        if base.get("m_updates_per_s_extrapolated_32t"):
            vs = mups / base["m_updates_per_s_extrapolated_32t"]
        elif base.get("m_updates_per_s"):
            vs = mups / base["m_updates_per_s"]
        if base.get("m_updates_per_s"):
            vs_host = mups / base["m_updates_per_s"]
        # bandwidth-capped 32-thread model (STREAM triad + bytes/update,
        # baselines/cpu_reference.json::realistic_32t_model) — the
        # defensible denominator; the linear extrapolation above is a
        # deliberate upper bound on the CPU
        real = (base.get("realistic_32t_model") or {}).get(
            "m_updates_per_s_realistic")
        if real:
            vs_real = mups / real

    print(
        json.dumps(
            {
                "metric": "edge_force_updates_per_s",
                "value": round(mups, 2),
                "unit": "M updates/s/device",
                "vs_baseline": round(vs, 2) if vs else None,
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )
    print(
        f"# card: {card}; n={graph.n} nnz={graph.nnz} model={bench_model} "
        f"dim=128 schedule=sync ns=5 iters={iters} "
        f"sec/iter={sec_per_iter*1e3:.3f}ms first_span={first_s:.1f}s "
        f"total_wall={time.time()-t0:.1f}s gather_dtype={gather_dtype} "
        f"vs_baseline=per-device / extrapolated-32-thread-AVX512 (linear "
        f"extrapolation overstates the CPU, so this is a lower bound); "
        f"vs_realistic (bw-capped 32t model, 250 M up/s): "
        f"{vs_real and round(vs_real, 2)}x; "
        f"vs 2-thread measured host: {vs_host and round(vs_host, 2)}x",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
