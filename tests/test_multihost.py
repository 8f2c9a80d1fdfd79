"""Multi-host plumbing tests on the virtual CPU mesh."""

import os

import jax
import numpy as np

from force2vec_tpu.dist.multihost import initialize, is_coordinator, pod_mesh

KARATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "karate.mtx")


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    initialize()  # must not raise or block


def test_pod_mesh_shape():
    mesh = pod_mesh(tp=2)
    assert mesh.shape["tp"] == 2
    assert mesh.shape["dp"] * 2 == len(jax.devices())
    assert is_coordinator()


def test_pod_mesh_runs_collective():
    mesh = pod_mesh(tp=1)
    out = jax.jit(
        jax.shard_map(
            lambda x: jax.lax.psum(x, "dp"),
            mesh=mesh,
            in_specs=jax.sharding.PartitionSpec("dp"),
            out_specs=jax.sharding.PartitionSpec(),
        )
    )(np.ones(len(jax.devices()), np.float32))
    assert float(np.asarray(out)[0]) == len(jax.devices())


def _run_two_process_workers(tmp_path, mode):
    """Launch 2 OS processes (2 virtual CPU devices each) joined by
    jax.distributed, train 3 iterations, return nothing (results land in
    tmp_path as emb_<pid>.npy)."""
    import os
    import socket
    import subprocess
    import sys

    # free port for the coordinator
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"localhost:{port}"

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "_mp_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid), str(tmp_path), mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"


def test_two_process_sync_step_matches_single(tmp_path):
    """SURVEY §4's multi-process simulation: two OS processes joined by
    jax.distributed (CPU backend, 2 virtual devices each) train 3 sync
    iterations over a (dp=2, tp=2) pod mesh; every process must produce
    exactly the single-process result — proving the cross-process psum/
    all_gather path, not just the single-process shard_map."""
    _run_two_process_workers(tmp_path, "sharded")

    # single-process reference on the in-test 8-device CPU mesh
    from force2vec_tpu.dist import make_mesh
    from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec
    from force2vec_tpu.graphs.io import read_mtx
    from force2vec_tpu.train.trainer import TrainConfig

    graph = read_mtx(KARATE)
    mesh = make_mesh(jax.devices()[:4], tp=2)
    want = ShardedSyncForce2Vec(
        graph, TrainConfig(dim=8, model="tdist", ns=3), mesh,
        min_width=4, hub_width=8,
    ).train(iters=3, seed=4)

    for pid in range(2):
        got = np.load(str(tmp_path / f"emb_{pid}.npy"))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_two_process_vertex_sharded_matches_single(tmp_path):
    """The vertex-sharded mode exists precisely for crossing host
    boundaries: train it on a vp=4 mesh
    spanning 2 OS processes and assert exact parity with the
    single-process vp=4 run — the all_to_all (cold halo), all_gather
    (hot tier), and psum (negative pool) all cross a real process
    boundary here."""
    _run_two_process_workers(tmp_path, "vp")

    from force2vec_tpu.dist.vertex_sharded import (
        VertexShardedForce2Vec,
        make_vp_mesh,
    )
    from force2vec_tpu.graphs.io import read_mtx
    from force2vec_tpu.train.trainer import TrainConfig

    graph = read_mtx(KARATE)
    want = VertexShardedForce2Vec(
        graph, TrainConfig(dim=8, model="tdist", ns=3),
        make_vp_mesh(jax.devices()[:4]), min_width=4, hub_width=8,
    ).train(iters=3, seed=4)

    for pid in range(2):
        got = np.load(str(tmp_path / f"emb_{pid}.npy"))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_two_process_cli_end_to_end(tmp_path):
    """`python -m force2vec_tpu --schedule vertex` works unmodified under
    2 jax.distributed processes: the CLI calls
    multihost.initialize() itself, trains on a vp=4 mesh spanning both
    processes, and only the coordinator writes the .embd + Results.txt."""
    import os
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"localhost:{port}"

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
    ).strip()
    outdirs = [str(tmp_path / f"r{pid}") for pid in range(2)]
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "force2vec_tpu.cli",
                "-input", KARATE,
                "-output", outdirs[pid], "-iter", "2", "-dim", "8",
                "--schedule", "vertex",
                "--coordinator", coord,
                "--num-processes", "2", "--process-id", str(pid),
            ],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"CLI worker failed:\n{out}\n{err}"
    emb0 = [f for f in os.listdir(outdirs[0]) if f.endswith(".embd")]
    assert emb0, "coordinator wrote no .embd"
    assert os.path.exists(os.path.join(outdirs[0], "Results.txt"))
    # non-coordinator writes nothing
    assert not os.path.exists(outdirs[1]) or not os.listdir(outdirs[1])
