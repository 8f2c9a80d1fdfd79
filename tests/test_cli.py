"""CLI + checkpoint tests: reference flag parity, ledger schema, resume."""

import os
import subprocess
import sys

import numpy as np
import pytest

from force2vec_tpu.graphs import read_embeddings, read_mtx
from force2vec_tpu.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    train_with_checkpoints,
)
from force2vec_tpu.train.trainer import Force2Vec, TrainConfig

KARATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "karate.mtx")


def _run_cli(args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "force2vec_tpu", *args],
        capture_output=True,
        text=True,
        cwd=str(tmp_path),
        env=env,
        timeout=600,
    )


def test_cli_reference_flags(tmp_path):
    out = _run_cli(
        ["-input", KARATE, "-output", str(tmp_path), "-batch", "16",
         "-iter", "5", "-dim", "8", "-nsamples", "3", "-option", "5"],
        tmp_path,
    )
    assert out.returncode == 0, out.stderr
    embds = [f for f in os.listdir(tmp_path) if f.endswith(".embd")]
    assert len(embds) == 1
    emb = read_embeddings(os.path.join(tmp_path, embds[0]))
    assert emb.shape == (34, 8)
    ledger = open(os.path.join(tmp_path, "Results.txt")).read()
    assert "BatchSize:16" in ledger and "Dimension:8" in ledger


def test_cli_eval_flag(tmp_path):
    out = _run_cli(
        ["-input", KARATE, "-output", str(tmp_path), "-batch", "34",
         "-iter", "60", "-dim", "8", "--eval"],
        tmp_path,
    )
    assert out.returncode == 0, out.stderr
    assert "Link prediction" in out.stdout


def test_checkpoint_roundtrip(tmp_path):
    emb = np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32)
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, emb, 42)
    back, it = load_checkpoint(p)
    assert it == 42
    np.testing.assert_array_equal(back, emb)


def test_checkpointed_training_matches_straight_run(tmp_path):
    graph = read_mtx(KARATE)
    cfg = TrainConfig(dim=8, batch_size=16, model="tdist", ns=3)
    straight = Force2Vec(graph, cfg).train(iters=9, seed=4)
    ck = train_with_checkpoints(
        Force2Vec(graph, cfg), iters=9, seed=4, every=3, ckpt_dir=str(tmp_path)
    )
    np.testing.assert_allclose(ck, straight, rtol=1e-6, atol=1e-7)
    # checkpoints exist and resume from the middle reproduces the end state
    ckpts = sorted(f for f in os.listdir(tmp_path) if f.startswith("ckpt_"))
    assert ckpts, "no checkpoints written"
    emb6, it6 = load_checkpoint(os.path.join(tmp_path, "ckpt_0000006.npz"))
    resumed = train_with_checkpoints(
        Force2Vec(graph, cfg),
        iters=9,
        seed=4,
        x0=emb6[: graph.n],
        start_iter=it6,
        every=3,
        ckpt_dir=str(tmp_path / "resume"),
    )
    np.testing.assert_allclose(resumed, straight, rtol=1e-6, atol=1e-7)


def test_cli_sync_schedule(tmp_path):
    out = _run_cli(
        ["-input", KARATE, "-output", str(tmp_path), "-iter", "40",
         "-dim", "8", "--schedule", "sync", "--eval"],
        tmp_path,
    )
    assert out.returncode == 0, out.stderr
    assert "Link prediction" in out.stdout


def _resume_matches_straight(make_runner, graph, tmp_path):
    """Generic resume ≡ straight-run assertion for any schedule runner."""
    straight = make_runner().train(iters=9, seed=4)
    ck = train_with_checkpoints(
        make_runner(), iters=9, seed=4, every=3, ckpt_dir=str(tmp_path)
    )
    np.testing.assert_allclose(ck, straight, rtol=1e-5, atol=1e-6)
    emb6, it6 = load_checkpoint(os.path.join(tmp_path, "ckpt_0000006.npz"))
    assert it6 == 6
    resumed = train_with_checkpoints(
        make_runner(), iters=9, seed=4, x0=emb6, start_iter=it6, every=3,
        ckpt_dir=str(tmp_path / "resume"),
    )
    np.testing.assert_allclose(resumed, straight, rtol=1e-5, atol=1e-6)


def test_checkpoint_resume_sync_schedule(tmp_path):
    from force2vec_tpu.train.sync import SyncForce2Vec

    graph = read_mtx(KARATE)
    cfg = TrainConfig(dim=8, model="tdist", ns=3)
    _resume_matches_straight(
        lambda: SyncForce2Vec(graph, cfg, min_width=4, hub_width=8),
        graph, tmp_path,
    )


def test_checkpoint_resume_vertex_schedule(tmp_path):
    import jax

    from force2vec_tpu.dist.vertex_sharded import (
        VertexShardedForce2Vec, make_vp_mesh,
    )

    graph = read_mtx(KARATE)
    cfg = TrainConfig(dim=8, model="tdist", ns=3)
    mesh = make_vp_mesh(jax.devices()[:4])
    _resume_matches_straight(
        lambda: VertexShardedForce2Vec(
            graph, cfg, mesh=mesh, min_width=4, hub_width=8
        ),
        graph, tmp_path,
    )


def test_checkpoint_resume_sharded_sync_schedule(tmp_path):
    import jax

    from force2vec_tpu.dist import make_mesh
    from force2vec_tpu.dist.sharded import ShardedSyncForce2Vec

    graph = read_mtx(KARATE)
    cfg = TrainConfig(dim=8, model="tdist", ns=3)
    mesh = make_mesh(jax.devices()[:4], tp=2)
    _resume_matches_straight(
        lambda: ShardedSyncForce2Vec(graph, cfg, mesh, min_width=4, hub_width=8),
        graph, tmp_path,
    )


def test_cli_checkpoint_on_sync_schedule(tmp_path):
    out = _run_cli(
        ["-input", KARATE, "-output", str(tmp_path), "-iter", "9", "-dim", "8",
         "--schedule", "sync", "--checkpoint-every", "3"],
        tmp_path,
    )
    assert out.returncode == 0, out.stderr
    ckpts = [f for f in os.listdir(tmp_path) if f.startswith("ckpt_")]
    assert ckpts, "sync schedule wrote no checkpoints"
