"""The port's process-group bootstrap and multi-rank command line on the
CPU (gloo): ``initialize`` is a no-op in one process; ``spawn`` fails fast
when a rank fails or hangs; ``python -m force2vec_tpu_torch --device cpu
--devices 2`` writes what one rank writes, with the JAX CLI's output name
and ``Results.txt`` row; a checkpointed two-rank vertex run resumes equal
to a straight run; and every module of the port imports with JAX and the
JAX package blocked."""

import gc
import os
import subprocess
import sys
import time
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from force2vec_tpu_torch import cli
from force2vec_tpu_torch.dist import multihost
from force2vec_tpu_torch.dist.spmd import SpmdAxes
from force2vec_tpu_torch.graphs import synth_powerlaw_graph
from force2vec_tpu_torch.graphs.io import read_embeddings
from force2vec_tpu_torch.graphs.tools import write_mtx
from force2vec_tpu_torch.train.checkpoint import load_checkpoint
from force2vec_tpu_torch.train.graph import IterationGraph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 4
NAME = "g.mtxF2VTDIST256D16IT4NS5.embd"  # batch min(256, n): n = 300


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    path = tmp_path_factory.mktemp("graph") / "g.mtx"
    write_mtx(synth_powerlaw_graph(n=300, avg_deg=6, seed=3), str(path))
    return str(path)


def _args(mtx, out, schedule, *extra):
    return ["-input", mtx, "-output", str(out), "-iter", str(ITERS), "-dim",
            "16", "--schedule", schedule, "--device", "cpu", *extra]


def _row(out):
    """The Results.txt row without its time field."""
    with open(os.path.join(out, "Results.txt")) as f:
        return f.read().strip().split("\t")[:-1]


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    assert multihost.world_size() == 1 and multihost.is_coordinator()
    assert multihost.pod_mesh(tp=1) == SpmdAxes()
    with pytest.raises(ValueError, match="world size and rank"):
        multihost.initialize(coordinator_address="localhost:1")
    assert not dist.is_initialized()


def _sum_ranks(rank, world):
    t = torch.full((2,), float(rank + 1))
    dist.all_reduce(t)
    g = multihost.pod_mesh(tp=2)
    return t.tolist(), (g.n_dp, g.n_tp, g.dp_index, g.tp_index)


def _fail_or_hang(rank, world, mode):
    if rank == 1:
        if mode == "raise":
            raise RuntimeError("rank 1 fails")
        time.sleep(600)  # a rank that never enters the collective
    t = torch.ones(1)
    dist.all_reduce(t)
    return float(t)


def test_spawn_runs_ranks_and_fails_fast():
    """Four ranks reduce and build (2, 2) groups; a rank that raises fails
    the spawn at once; a rank that hangs is killed at the time limit."""
    res = multihost.spawn(_sum_ranks, 4, threads=1)
    assert [r[0] for r in res] == [[10.0, 10.0]] * 4
    assert [r[1] for r in res] == [(2, 2, r // 2, r % 2) for r in range(4)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        multihost.spawn(_fail_or_hang, 2, args=("raise",), timeout=60,
                        threads=1)
    with pytest.raises(RuntimeError, match="limit"):
        multihost.spawn(_fail_or_hang, 2, args=("hang",), timeout=60,
                        threads=1, wait=5)
    assert time.monotonic() - t0 < 40


def _slow_to_leave(rank, world):
    """A rank whose group teardown never ends (as NCCL's does under a live
    CUDA graph that captured the group's collectives): its result is
    written before it."""
    dist.destroy_process_group = lambda: time.sleep(600)
    return rank


def test_spawn_raises_when_a_rank_cannot_leave_its_group(monkeypatch):
    """Ranks that have written their results and hang while leaving the
    group are killed after ``EXIT_GRACE`` seconds and ``spawn`` raises,
    even with no time limit (``wait=math.inf``, as the command line
    spawns)."""
    monkeypatch.setattr(multihost, "EXIT_GRACE", 1.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not leave their process"):
        multihost.spawn(_slow_to_leave, 2, threads=1, wait=float("inf"))
    assert time.monotonic() - t0 < 60


class _Trainer:
    """A trainer and its graph, which hold each other as the runners'
    do."""

    def __init__(self):
        self.span_graph = IterationGraph(self._prepare, self._body, ())
        self.span_graph.graphs, self.span_graph.key = ["captured"], ("x",)

    def _prepare(self, seed, it):
        pass

    def _body(self, x):
        pass


def test_shutdown_drops_every_graph_before_the_group(monkeypatch):
    """``shutdown`` resets every live ``IterationGraph``, one whose trainer
    only a reference cycle keeps alive too, before it destroys the group:
    NCCL destroys a communicator only once no graph that captured it is
    left."""
    live = _Trainer()
    collecting = gc.isenabled()
    gc.disable()  # the dead trainer's cycle stays until shutdown
    try:
        dead = weakref.ref(_Trainer().span_graph)
        seen = []
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "destroy_process_group", lambda: seen.append(
            (live.span_graph.graphs, dead().graphs)))
        multihost.shutdown()
    finally:
        if collecting:
            gc.enable()
    assert seen == [([], [])]
    assert live.span_graph.key is None


@pytest.mark.parametrize("schedule", ["vertex", "sync"])
def test_two_ranks_write_the_single_rank_output(mtx, tmp_path, schedule):
    """``python -m force2vec_tpu_torch --devices 2`` (two gloo ranks) and
    one process write the same ``.embd`` (within the text's rounding) and
    ``Results.txt`` row; the JAX CLI names and rows its run the same."""
    two, one = tmp_path / "two", tmp_path / "one"
    env = {**os.environ, "PYTHONPATH": ROOT}
    subprocess.run([sys.executable, "-m", "force2vec_tpu_torch",
                    *_args(mtx, two, schedule, "--devices", "2")],
                   check=True, cwd=ROOT, env=env, capture_output=True)
    assert cli.main(_args(mtx, one, schedule)) == 0
    assert sorted(os.listdir(two)) == ["Results.txt", NAME]
    np.testing.assert_allclose(read_embeddings(str(two / NAME)),
                               read_embeddings(str(one / NAME)),
                               rtol=1e-5, atol=1e-6)
    assert _row(two) == _row(one)

    from force2vec_tpu import cli as jax_cli

    ref = tmp_path / "jax"
    args = _args(mtx, ref, schedule, "--devices", "2")
    assert jax_cli.main(args[: args.index("--device")]
                        + ["--devices", "2"]) == 0
    assert sorted(os.listdir(ref)) == ["Results.txt", NAME]
    assert _row(ref) == _row(two)


def test_two_rank_vertex_resume_equals_straight_run(mtx, tmp_path):
    """Two ranks checkpoint every 2 iterations (rank 0 writes); two ranks
    resumed from the middle checkpoint end where the straight run ends."""
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    assert cli.main(_args(mtx, straight, "vertex", "--devices", "2",
                          "--checkpoint-every", "2")) == 0
    mid = straight / "ckpt_0000002.npz"
    assert cli.main(_args(mtx, resumed, "vertex", "--devices", "2",
                          "--resume", str(mid),
                          "--checkpoint-every", "2")) == 0
    want, it = load_checkpoint(str(straight / f"ckpt_{ITERS:07d}.npz"))
    got, it2 = load_checkpoint(str(resumed / f"ckpt_{ITERS:07d}.npz"))
    assert it == it2 == ITERS
    np.testing.assert_array_equal(got, want)
    assert not (resumed / "ckpt_0000002.npz").exists()


def test_async_checkpoint_fetch_refused_with_ranks():
    assert multihost.spawn(_async_refused, 2, threads=1) == ["refused"] * 2


def _async_refused(rank, world):
    from force2vec_tpu_torch.train.checkpoint import train_with_checkpoints

    try:
        train_with_checkpoints(None, iters=1, async_fetch=True)
    except ValueError as e:
        return "refused" if "refused" in str(e) else str(e)
    return "ran"


def test_port_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke.py, import with ``jax``,
    ``jaxlib`` and ``force2vec_tpu`` unimportable."""
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'force2vec_tpu'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import force2vec_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                              pkg.__name__ + '.')]\n"
        "for name in mods + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "want = ['graphs.partition', 'dist', 'dist.spmd', 'dist.multihost',\n"
        "        'dist.sharded', 'dist.vertex_sharded', 'utils.profiling']\n"
        "missing = [w for w in want if 'force2vec_tpu_torch.' + w not in mods]\n"
        "assert not missing, missing\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                         capture_output=True, text=True).stdout
    assert int(out) >= 40


def test_meter_times_phases_on_the_cpu():
    from force2vec_tpu_torch.utils.profiling import Meter

    m = Meter("cpu")
    for _ in range(2):
        with m.phase("a"):
            torch.ones(64).sum()
    assert m.seconds["a"] > 0
