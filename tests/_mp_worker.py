"""Worker for the multi-process distributed tests (test_multihost.py).

Usage: python _mp_worker.py <coordinator> <num_procs> <proc_id> <out_dir> [mode]

Each process exposes 2 virtual CPU devices; together they form a 4-device
pod mesh spanning 2 OS processes.  mode='sharded' (default) trains the
replicated-X dp=2 x tp=2 schedule; mode='vp' trains the vertex-sharded
schedule (X partitioned over vp=4, the mode built precisely for crossing
host boundaries) so its all_to_all / all_gather / psum path runs across a
real process boundary.  Every process writes its result; the test asserts
both match the single-process answer.
"""

import os
import sys


def main():
    coord, nproc, pid, out_dir = sys.argv[1:5]
    mode = sys.argv[5] if len(sys.argv) > 5 else "sharded"
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from force2vec_tpu.dist.multihost import initialize, pod_mesh

    initialize(coordinator_address=coord, num_processes=int(nproc), process_id=int(pid))
    assert jax.process_count() == int(nproc), jax.process_count()
    assert len(jax.devices()) == 2 * int(nproc), len(jax.devices())

    import numpy as np

    from force2vec_tpu.graphs.io import read_mtx
    from force2vec_tpu.train.trainer import TrainConfig

    graph = read_mtx(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "karate.mtx"))
    cfg = TrainConfig(dim=8, model="tdist", ns=3)
    if mode == "vp":
        from force2vec_tpu.dist.vertex_sharded import (
            VertexShardedForce2Vec,
            make_vp_mesh,
        )

        runner = VertexShardedForce2Vec(
            graph, cfg, make_vp_mesh(), min_width=4, hub_width=8
        )
    else:
        from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec

        mesh = pod_mesh(tp=2)
        runner = ShardedSyncForce2Vec(graph, cfg, mesh, min_width=4, hub_width=8)
    emb = runner.train(iters=3, seed=4)
    np.save(os.path.join(out_dir, f"emb_{pid}.npy"), emb)
    print(f"proc {pid}: ok", flush=True)


if __name__ == "__main__":
    main()
