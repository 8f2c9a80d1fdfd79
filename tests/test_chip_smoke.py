"""chip_smoke.py's phases at tiny size on the CPU (no device check), its
refusal to run without a GPU, and one card-only test (marker ``gpu``)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KARATE = os.path.join(REPO, "tests", "data", "karate.mtx")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("schedule", ["sync", "batch"])
def test_cli_phase(tmp_path, schedule):
    info = chip_smoke.phase_cli(KARATE, str(tmp_path), schedule, iters=3, dim=8)
    assert info["embd"].endswith(".embd")


@pytest.mark.parametrize("model", ["tdist", "rwalk"])
def test_sync_phase(tmp_path, model):
    from bench import synth_powerlaw_graph

    g = synth_powerlaw_graph(n=512, avg_deg=8)
    info = chip_smoke.phase_sync(g, model, iters=2, out_dir=str(tmp_path), dim=16)
    assert info["ms_iter"] > 0
    assert info["step_memory"]["output_size_in_bytes"] > 0
    assert os.path.exists(tmp_path / f"sync_{model}.embd")


@pytest.mark.parametrize(
    "model", ["tdist", "sigmoid", "rwalk", "fr", "linlog", "forceatlas"])
def test_parity_phase(model):
    """The oracle comparison, on a graph small enough for the CPU but with
    hub virtual rows (max degree above hub_width)."""
    info = chip_smoke.phase_parity(n=300, dim=16, hub_width=16, models=(model,))
    assert info["max_deg"] > 16
    assert info[model]["f32_vs_oracle"] <= chip_smoke.F32_TOL
    assert 0 < info[model]["bf16_vs_f32"] <= chip_smoke.BF16_TOL


def test_quality_phase():
    info = chip_smoke.phase_quality(n=400, iters=100, dim=16, floor=0.9)
    assert info["auc"] >= 0.9


def test_distance_auc_extremes():
    from force2vec_tpu.graphs.csr import Graph

    # two far-apart cliques: edges are short, most random pairs long
    n = 40
    blk = np.arange(n) // 20
    r, c = np.nonzero((blk[:, None] == blk[None, :]) & ~np.eye(n, dtype=bool))
    g = Graph.from_coo(r, c, None, n=n)
    emb = np.where(blk[:, None] == 0, 0.0, 100.0) + np.zeros((n, 4))
    emb += np.random.default_rng(0).normal(scale=0.01, size=emb.shape)
    assert chip_smoke.distance_auc(g, emb) > 0.7
    noise = np.random.default_rng(1).normal(size=emb.shape)
    assert 0.3 < chip_smoke.distance_auc(g, noise) < 0.7


def test_write_mtx_roundtrip(tmp_path):
    from bench import synth_powerlaw_graph
    from force2vec_tpu.graphs import read_mtx

    g = synth_powerlaw_graph(n=300, avg_deg=6)
    path = str(tmp_path / "g.mtx")
    chip_smoke.write_mtx(g, path)
    back = read_mtx(path)
    assert back.n == g.n and back.nnz == g.nnz
    np.testing.assert_array_equal(back.rowptr, g.rowptr)
    np.testing.assert_array_equal(np.sort(back.colids), np.sort(g.colids))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_exits_nonzero_without_gpu(tmp_path, where):
    """No GPU (or no repository beside the script): non-zero exit, no
    result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_parity_phase_on_gpu():
    """Oracle parity at D=128 on the card.  The check runs in a child
    process that may see the GPU (this process is pinned to the CPU by
    conftest); it skips where JAX finds no GPU."""
    code = (
        "import sys, jax\n"
        "try:\n"
        "    gpu = jax.devices()[0].platform == 'gpu'\n"
        "except RuntimeError:\n"
        "    gpu = False\n"
        "if not gpu:\n"
        "    sys.exit(3)\n"
        "import json, chip_smoke\n"
        "print(json.dumps(chip_smoke.phase_parity(n=1000, hub_width=32)))\n"
    )
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = ""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode == 3:
        pytest.skip("JAX finds no GPU here")
    assert out.returncode == 0, out.stderr[-3000:]
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["tdist"]["f32_vs_oracle"] <= chip_smoke.F32_TOL
