"""Multi-host layer in its single-process degenerate form on the
8-device CPU mesh (the make_array_from_callback path is exactly what a
multi-process run executes per host)."""

import numpy as np

from recsys_tpu.config import RunConfig
from recsys_tpu.engine.oracle import run_oracle
from recsys_tpu.io.generator import generate_instance
from recsys_tpu.io.parser import load_problem
from recsys_tpu.parallel import multihost

from helpers import FIXTURES


def test_initialize_noop_single_process():
    multihost.initialize()  # must not raise or try to bind sockets


def test_multihost_matches_oracle_small():
    spec = load_problem(str(FIXTURES / "inst30-40-10-2-10.in"))
    out, top1 = multihost.run(spec, RunConfig(dtype="float64"))
    golden = open(FIXTURES / "inst30-40-10-2-10.out").read()
    assert out == golden


def test_multihost_equals_singlehost_engine():
    from recsys_tpu.parallel import engine

    spec = generate_instance(24, 36, 6, 1, 6, iters=8, alpha=0.005, seed=3)
    cfg = RunConfig(dtype="float32", path="dense")
    out_mh, top_mh = multihost.run(spec, cfg)
    out_sh, top_sh = engine.run(spec, cfg)
    np.testing.assert_array_equal(top_mh, top_sh)
    assert out_mh == out_sh


def test_multihost_dense_route_golden():
    """f32 on the sharded dense route (true-f32 products) with
    per-process block assembly; golden end-to-end."""
    spec = load_problem(str(FIXTURES / "inst30-40-10-2-10.in"))
    out, _ = multihost.run(spec, RunConfig(dtype="float32", path="dense"))
    assert out == open(FIXTURES / "inst30-40-10-2-10.out").read()


def test_multihost_bell_route_golden():
    """Explicit BELL through the multi-host layer: the sharded-BELL
    tables upload via the per-process block callback (stacked (pu, pi)
    leading dims make every shard's slice process-local)."""
    spec = load_problem(str(FIXTURES / "inst30-40-10-2-10.in"))
    out, _ = multihost.run(spec, RunConfig(dtype="float32", path="bell"))
    assert out == open(FIXTURES / "inst30-40-10-2-10.out").read()
