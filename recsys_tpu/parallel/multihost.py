"""Multi-host (multi-process) execution layer.

The reference's multi-node story is MPI: mpirun launches P ranks, rank 0
streams COO chunks to owners (``matFact-mpi.c:220-457``), factor blocks
are scattered in RNG order (``matFact-mpi.c:459-515``) and every
iteration ends in two Allreduces over row/col communicators
(``matFact-mpi.c:207-209``). The JAX analogue:

* ``jax.distributed.initialize`` replaces ``MPI_Init`` — one process per
  host, each seeing its local devices; collectives (NCCL on GPUs) are
  scheduled by XLA, not hand-written sends.
* The global 2-D ('u', 'i') mesh spans all processes' devices. The same
  ``shard_map`` training step from ``parallel/step.py`` runs unchanged —
  multi-host is a deployment property of the mesh, not a different code
  path (contrast: the reference duplicates its whole driver per backend).
* Ingest is per-process: every host parses the (shared-filesystem) input
  and keeps only the blocks its devices own —
  ``jax.make_array_from_process_local_data`` assembles the global arrays.
  No root-streams-to-workers phase: the parse is a tiny fraction of run
  time (native C parser) and skipping the scatter removes the reference's
  serial ingest bottleneck and its empty-rank deadlock protocol
  (``matFact-mpi.c:377-405``).
* Factors are generated on every host in the serial RNG order (identical
  bits, SURVEY §0 contract) and sharded by ``device_put`` — the analogue
  of the reference's carefully-ordered generate-and-scatter, with the
  ordering problem dissolved by replication instead of choreography.
* Output: the sharded top-1 already produces a result replicated along
  'i'; ``process_allgather`` collects the 'u'-sharded indices to every
  host (the reference's Gatherv to root, ``matFact-mpi.c:105-144``).

Single-process (CPU mesh or one host × N devices) is the degenerate case:
``initialize()`` is a no-op and the per-process block set is the whole
problem — which is how the unit tests exercise this module.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import NamedSharding

from recsys_tpu.config import ProblemSpec, RunConfig
from recsys_tpu.models.mf import MFState
from recsys_tpu.parallel.mesh import make_mesh


def initialize(coordinator_address: str | None = None, num_processes: int | None = None, process_id: int | None = None) -> None:
    """``MPI_Init`` analogue. No-op when single-process (the common case
    in tests and single-host runs); with arguments (or the standard
    cluster env vars) brings up the cross-host runtime."""
    if num_processes is None and coordinator_address is None:
        return  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def _local_block_array(global_np: np.ndarray, sharding: NamedSharding):
    """Assemble a global sharded array by uploading only the blocks owned
    by this process's addressable devices."""
    return jax.make_array_from_callback(
        global_np.shape, sharding, lambda idx: global_np[idx]
    )


def factorize_multihost(
    spec: ProblemSpec,
    cfg: RunConfig = RunConfig(),
    mesh=None,
) -> tuple[MFState, "jax.sharding.Mesh"]:
    """Training over the global (all-process) mesh — every path of the
    sharded engine (dense, BELL and both COO forms, so the
    huge sparse instances multi-host exists for route here too).

    The only difference from the single-process engine is array
    placement: each process materializes and uploads only the blocks its
    addressable devices own (``_local_block_array``).  The jitted
    shard_map programs are byte-identical.
    """
    from recsys_tpu.parallel.engine import factorize_sharded

    if mesh is None:
        mesh = make_mesh(spec.users, spec.items, shape=cfg.mesh_shape)
    return factorize_sharded(spec, cfg, mesh=mesh, putter=_local_block_array)


def recommend_multihost(state: MFState, spec: ProblemSpec, mesh, cfg: RunConfig = RunConfig()) -> np.ndarray:
    """Distributed top-1, gathered to every process (Gatherv analogue).
    Shares the single-process pipeline (compact rated-table masking, see
    ``parallel.engine.sharded_top1_device``); only array placement and
    the final cross-process gather differ."""
    from recsys_tpu.engine.trainer import matmul_precision
    from recsys_tpu.parallel.engine import sharded_top1_device

    top1 = sharded_top1_device(
        state, spec, mesh, putter=_local_block_array, precision=matmul_precision(cfg)
    )
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        top1 = multihost_utils.process_allgather(top1, tiled=True)
    return np.asarray(top1)[: spec.users]


def run(spec: ProblemSpec, cfg: RunConfig = RunConfig()) -> tuple[str, np.ndarray]:
    from recsys_tpu.io.writers import format_recommendations

    state, mesh = factorize_multihost(spec, cfg)
    top1 = recommend_multihost(state, spec, mesh, cfg)
    return format_recommendations(top1, spec.rated_counts(), spec.items), top1
