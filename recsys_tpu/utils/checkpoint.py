"""Checkpoint / resume of factorization state.

The reference has no checkpointing — state lives in process memory for
the fixed iteration count and dies with the run (SURVEY §5). For a
production service that is not acceptable: long runs on preemptible
hardware need snapshot/restore. State is tiny (two dense factor tables
plus the iteration cursor), so a single-file numpy archive is the whole
mechanism; the arrays are fetched from device, written atomically, and
restored with ``trainer.factorize(..., state=..., )`` on the remaining
iterations.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from recsys_tpu.models.mf import MFState


class Checkpoint(NamedTuple):
    state: MFState
    completed_iters: int


def save(path: str, state: MFState, completed_iters: int) -> None:
    """Atomically snapshot (L, R, completed_iters)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    np.savez(
        tmp,
        L=np.asarray(state.L),
        R=np.asarray(state.R),
        completed_iters=np.int64(completed_iters),
    )
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load(path: str) -> Checkpoint:
    with np.load(path) as z:
        return Checkpoint(
            state=MFState(L=z["L"], R=z["R"]),
            completed_iters=int(z["completed_iters"]),
        )


def run_with_checkpoints(spec, cfg, path: str, every: int):
    """Factorize with a snapshot every ``every`` iterations, resuming
    from ``path`` if it exists. Returns the final MFState.

    Each chunk is one jitted fori_loop dispatch; the snapshot cost is a
    device->host fetch of the factors between chunks.
    """
    import dataclasses

    from recsys_tpu.engine import trainer

    done = 0
    state = None
    if os.path.exists(path):
        ck = load(path)
        state, done = ck.state, ck.completed_iters
    while done < spec.iters:
        chunk = min(every, spec.iters - done)
        chunk_spec = dataclasses.replace(spec, iters=chunk)
        state = trainer.factorize(chunk_spec, cfg, state=state)
        state = MFState(L=np.asarray(state.L), R=np.asarray(state.R))
        done += chunk
        save(path, state, done)
    return state
