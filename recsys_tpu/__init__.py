"""recsys_tpu — a matrix-factorization recommender framework on JAX.

A ground-up JAX/XLA/shard_map re-design of the capabilities of the
reference C/OpenMP/MPI recommender (vladstojna/recommender-system):
full-batch gradient-descent matrix factorization over a sparse ratings
matrix, with bit-compatible deterministic initialization, top-1
recommendation output, single-device and multi-device (2-D
checkerboard mesh) execution paths, and a benchmarking harness.  It
runs on NVIDIA GPUs (and on the CPU backend for tests).

Layout:
  io/        ingest (.in parser), glibc-random() recreation, writers, generator
  models/    factor-model state and deterministic initialization
  ops/       compute: dense masked-GD, BELL and COO sparse steps, top-1
  parallel/  mesh construction, checkerboard sharding, shard_map train step
  engine/    numpy oracle, jitted trainers, end-to-end runner
  utils/     timing, compile cache, checkpoints
  cli.py     command-line entry points
"""

from recsys_tpu.config import ProblemSpec
from recsys_tpu.io.parser import load_problem, parse_in_bytes
from recsys_tpu.models.mf import init_factors

__all__ = [
    "ProblemSpec",
    "load_problem",
    "parse_in_bytes",
    "init_factors",
]

__version__ = "0.1.0"
