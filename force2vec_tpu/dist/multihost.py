"""Multi-process bootstrap and cross-process meshes.

The reference is strictly single-process (SURVEY.md §2.5); this module is
the scale-out story.  One process per host (or per card group), each
seeing its local devices; ``initialize()`` wires them into one JAX runtime
(``jax.distributed``), after which every array/collective in dist/sharded
spans all processes transparently.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bootstrap this process into a multi-host JAX runtime.

    With no arguments, reads the standard env vars (JAX_COORDINATOR_ADDRESS
    / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  Safe to call when
    single-process (no coordinator configured): it no-ops.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator_address:
        return  # single process
    kwargs = {"coordinator_address": coordinator_address}
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    elif os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None:
        kwargs["process_id"] = process_id
    elif os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(**kwargs)


def pod_mesh(tp: int = 1) -> Mesh:
    """(dp, tp) mesh over every device in the (possibly multi-process)
    runtime.  Devices are ordered by process, so the tp axis stays within
    a process and dp spans processes.
    """
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = len(devices)
    assert n % tp == 0, f"{n} devices not divisible by tp={tp}"
    arr = np.asarray(devices).reshape(n // tp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))


def is_coordinator() -> bool:
    """True on the process that should write checkpoints/output."""
    return jax.process_index() == 0
