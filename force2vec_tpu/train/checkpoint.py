"""Checkpoint / resume — a subsystem the reference lacks entirely
(SURVEY.md §5: single final ``.embd`` write, no resume path).

A checkpoint is one ``.npz``: the full padded embedding, the iteration
count, and enough config to sanity-check a resume.  Writes are atomic
(temp file + rename) so a kill mid-write can't corrupt the latest
checkpoint.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np


def save_checkpoint(path: str, emb: np.ndarray, iteration: int, meta: dict = None) -> None:
    """Atomically write embedding + iteration (+ metadata) to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, emb=np.asarray(emb), iteration=iteration, **(meta or {}))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Tuple[np.ndarray, int]:
    """Return (embedding, iteration)."""
    with np.load(path) as z:
        return z["emb"], int(z["iteration"])


def train_with_checkpoints(
    runner,
    iters: int,
    seed: int = 1,
    x0: Optional[np.ndarray] = None,
    start_iter: int = 0,
    every: int = 100,
    ckpt_dir: str = ".",
    keep: int = 3,
    verbose: bool = False,
    async_fetch: Optional[bool] = None,
) -> np.ndarray:
    """Train in ``every``-iteration spans, checkpointing after each span.

    Works with ANY schedule runner (batch Force2Vec, SyncForce2Vec,
    ShardedForce2Vec/ShardedSyncForce2Vec, VertexShardedForce2Vec): all
    expose ``_train_jit(garr, x, key, num_iters, iter_offset)`` plus
    ``pad_embedding / init_embedding / unpad_embedding``.  Checkpoints
    store the CANONICAL host embedding ([n, D], original vertex order),
    so a run checkpointed under one schedule can resume under another.

    The RNG stream is keyed by absolute iteration (jax.random.fold_in in
    every train fn), so a resumed run continues the same sample sequence a
    straight run would have drawn.

    ``async_fetch`` (default: on for single-process runs) overlaps the
    device→host embedding fetch and the file write with the NEXT training
    span in a background thread, so neither sits on the critical path of
    every span.  Safe because span programs do not donate the embedding carry
    (make_train_dispatcher) — the fetched buffer stays immutable while
    the next span computes a fresh one.  Multi-host keeps the synchronous
    path: unpad_embedding may be collective and must be entered by every
    rank in deterministic order with no concurrent dispatch.
    """
    import jax

    # Multi-host: every process runs the same spans (unpad_embedding may
    # contain a cross-process allgather, which all ranks must enter), but
    # only the coordinator touches the filesystem.
    write_files = jax.process_index() == 0
    if async_fetch is None:
        async_fetch = jax.process_count() == 1

    x = runner.pad_embedding(x0) if x0 is not None else runner.init_embedding(seed)
    key = jax.random.PRNGKey(seed)
    done = start_iter
    paths = []

    def write_one(emb_host, at_iter):
        path = os.path.join(ckpt_dir, f"ckpt_{at_iter:07d}.npz")
        save_checkpoint(
            path, emb_host, at_iter, {"seed": seed, "dim": runner.config.dim}
        )
        paths.append(path)
        if len(paths) > keep:
            old = paths.pop(0)
            if os.path.exists(old):
                os.unlink(old)
        if verbose:
            print(f"checkpoint @ iter {at_iter} -> {path}")

    import threading

    pending: list = []

    def flush():
        while pending:
            pending.pop(0).join()

    while done < iters:
        k = min(every, iters - done)
        x = runner._train_jit(runner._garr, x, key, k, done)
        done += k
        if async_fetch:
            if not write_files:
                continue
            flush()  # at most one in-flight fetch; writes stay ordered
            t = threading.Thread(
                target=lambda xs=x, ds=done: write_one(
                    runner.unpad_embedding(xs), ds),
                daemon=True,
            )
            t.start()
            pending.append(t)
            continue
        emb_host = runner.unpad_embedding(x)  # every rank: may be collective
        if write_files:
            write_one(emb_host, done)
    flush()
    return runner.unpad_embedding(x)
