"""The step as a device scalar and the static-buffer span that a CUDA
graph captures (``force2vec_tpu_torch/train/graph.py``), on the CPU.

On a card ``run_span`` and ``train()`` capture one iteration as a CUDA
graph and replay it; the iteration then reads its step from the trainer's
0-d f32 step buffer and draws its negatives and walks from the trainer's
generator, re-seeded before each replay.  No graph is captured on the CPU,
but the code a graph captures runs here eagerly: each wrapper's plain
version and each trainer's iteration with a tensor step, and the trainers'
``span_graph.run_uncaptured`` (the host's ``_prepare_iteration``, then
the captured ``_static_iteration``).  Everything here is held bit for bit:

* each kernel wrapper (its plain version here) with the step as a 0-d
  tensor against the step as a float, for every model and X dtype;
* both trainers' iterations with the step buffer against a float step,
  over three iterations of the decay999 schedule's changing step;
* the static-buffer span against ``_run_span_eager`` (the loop the card
  no longer runs): straight, split into spans, and resumed from a
  checkpoint.

``run_iteration`` stays the eager parity entry point; its tolerances
against the JAX package are those of the other ``test_torch_*`` modules,
which this module leaves as they are.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from force2vec_tpu_torch.graphs import load_graph
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.ops import force_kernels as fk
from force2vec_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
from force2vec_tpu_torch.train.graph import StepBuffer
from force2vec_tpu_torch.train.sync import SyncForce2Vec
from force2vec_tpu_torch.train.trainer import (Force2Vec, TrainConfig,
                                               step_at)

KARATE = os.path.join(os.path.dirname(__file__), "data", "karate.mtx")
DIM, BS, NS = 12, 8, 5
DTYPES = ("float32", "bfloat16", "float16")
SYNC_MODELS = ("tdist", "sigmoid", "sigmoid_table", "rwalk", "fr", "linlog",
               "forceatlas")
BATCH_MODELS = SYNC_MODELS + ("tdist_exact",)
SEPARABLE = ("tdist", "sigmoid", "sigmoid_table", "fr", "linlog",
             "forceatlas")
ITERS = 3  # the decay999 step changes at each
SEED = 11


@pytest.fixture(scope="module")
def graph():
    return load_graph(KARATE)


def _config(model: str, dtype: str, **kw) -> TrainConfig:
    table = model.endswith("_table")
    return TrainConfig(dim=DIM, batch_size=BS, ns=NS,
                       model=model[:-6] if table else model, sm_table=table,
                       dtype=dtype, **kw)


def _t(step: float) -> torch.Tensor:
    return torch.tensor(step, dtype=torch.float32)


def _steps(fv):
    """The first ITERS steps of the run, each as step_at gives it."""
    return [step_at(fv.model, fv.lr, it, fv._dtype) for it in range(ITERS)]


# -- each wrapper's plain version, float step vs tensor step ---------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", SEPARABLE)
def test_kernel_plain_versions_take_a_tensor_step(graph, model, dtype):
    fv = SyncForce2Vec(graph, _config(model, dtype), device="cpu")
    m = fv.model
    x = fv.init_embedding(seed=3)
    xg = fv._replica(x)
    rng = np.random.default_rng(5)
    step = step_at(m, fv.lr, 7, fv._dtype)  # a decayed step where decay999
    table = fv.edge_table
    ng = -(-fv.layout.n_pad // BS)
    sg = xg[torch.as_tensor(rng.integers(0, graph.n - 1, (ng, NS)))]
    idx = torch.as_tensor(rng.integers(0, graph.n - 1, (fv.layout.n_pad, NS)),
                          dtype=torch.int32)
    a = torch.as_tensor(rng.random(table.nbr.shape[0]), dtype=torch.float32)
    upd = torch.zeros_like(x).uniform_(-0.1, 0.1)
    calls = {
        "edge table": lambda s: fk.ell_edge_force_table(
            m, x, xg, table, fv.inv_deg, s),
        "edge": lambda s: fk.ell_edge_force(
            m, x, xg, *table.parts()[0][:3], fv.inv_deg, s),
        "sample": lambda s: fk.ell_sample_force(
            m, x, xg, idx, fv._ns_deg, fv._all_rows, s),
        "sample adding": lambda s: fk.ell_sample_force(
            m, x, xg, idx, fv._ns_deg, fv._all_rows, s, out=upd.clone(),
            accumulate=True),
        "grouped store": lambda s: fk.grouped_rep_force(m, BS, x, sg, s),
        "grouped add": lambda s: fk.grouped_rep_force(
            m, BS, x, sg, s, mode="add", out=upd.clone()),
        "tp force edge": lambda s: fk.tp_pair_force(
            m, "edge", x, xg, table, a, fv.inv_deg, s),
    }
    if m.update != "energy":
        calls["grouped apply"] = lambda s: fk.grouped_rep_force(
            m, BS, x.clone(), sg, s, mode="apply", upd=upd)
    for what, call in calls.items():
        want = call(step)
        got = call(_t(step))
        assert torch.equal(got, want), what
        assert torch.isfinite(want.float()).all(), what


def test_step_scalar_takes_floats_and_one_kind_of_tensor():
    s = fk._step_scalar(0.25, torch.device("cpu"))
    assert s.dtype == torch.float32 and s.dim() == 0 and float(s) == 0.25
    buf = _t(0.5)
    assert fk._step_scalar(buf, torch.device("cpu")) is buf
    for bad in (torch.tensor(0.5, dtype=torch.float64), torch.tensor([0.5]),
                torch.tensor(0.5, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="0-d float32"):
            fk._step_scalar(bad, torch.device("cpu"))


# -- the trainers' iterations, float step vs the step buffer ---------------------


def _sync_draws(fv, it):
    gen = torch.Generator().manual_seed(100 + it)
    return fv._draw(gen)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", SYNC_MODELS + ("tdist -bs 1",))
def test_sync_iterations_with_the_step_buffer(graph, model, dtype):
    pv = model.endswith("-bs 1")
    fv = SyncForce2Vec(graph, _config(model.split()[0], dtype,
                                      per_vertex_samples=pv), device="cpu")
    xa = fv.init_embedding(seed=2)
    xb = xa.clone()
    for it, step in enumerate(_steps(fv)):
        negs, walks = _sync_draws(fv, it)
        fv._iteration(xa, negs, walks, step, plain=False)
        fv._iteration(xb, negs, walks, fv._step_buf.write(step),
                      plain=False)
        assert torch.equal(xa, xb), f"iteration {it}"
    assert not torch.equal(xa, fv.init_embedding(seed=2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", BATCH_MODELS + ("tdist -bs 1",))
def test_batch_iterations_with_the_step_buffer(graph, model, dtype):
    pv = model.endswith("-bs 1")
    fv = Force2Vec(graph, _config(model.split()[0], dtype,
                                  per_vertex_samples=pv), device="cpu")
    xa = fv.init_embedding(seed=2)
    xb = xa.clone()
    for it, step in enumerate(_steps(fv)):
        negs, walks = fv._draw(torch.Generator().manual_seed(100 + it))
        fv._iteration(xa, negs, walks, step)
        fv._iteration(xb, negs, walks, fv._step_buf.write(step))
        assert torch.equal(xa, xb), f"iteration {it}"
    assert not torch.equal(xa, fv.init_embedding(seed=2))


# -- the static-buffer span against the eager loop -----------------------------

# (trainer, model, TrainConfig fields): both trainers' modes and X dtypes
SPAN_CASES = (
    ("sync", "tdist", dict(gather_dtype="bfloat16")),
    ("sync", "tdist", dict(dtype="bfloat16")),
    ("sync", "tdist", dict(dtype="float16", per_vertex_samples=True)),
    ("sync", "rwalk", {}),
    ("sync", "fr", dict(dtype="float16")),
    ("sync", "linlog", {}),
    ("sync", "sigmoid_table", {}),
    ("batch", "tdist", {}),
    ("batch", "tdist", dict(dtype="bfloat16", per_vertex_samples=True)),
    ("batch", "rwalk", {}),
    ("batch", "forceatlas", dict(dtype="float16")),
    ("batch", "tdist_exact", {}),
)
SPAN_IDS = [f"{t}-{m}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
            for t, m, kw in SPAN_CASES]


def _trainer(graph, kind, model, kw):
    table = model.endswith("_table")
    cfg = dataclasses.replace(
        _config(model, kw.get("dtype", "float32")),
        **{k: v for k, v in kw.items() if k != "dtype"})
    if kind == "batch":
        return Force2Vec(graph, cfg, device="cpu")
    assert not table or cfg.sm_table
    return SyncForce2Vec(graph, cfg, device="cpu")


def _emb(fv, x):
    return fv.unpad_embedding(x)


@pytest.mark.parametrize("kind,model,kw", SPAN_CASES, ids=SPAN_IDS)
def test_static_span_equals_the_eager_loop(graph, kind, model, kw):
    fv = _trainer(graph, kind, model, kw)
    x0 = fv.init_embedding(seed=SEED)
    want, got = x0.clone(), x0.clone()
    fv._run_span_eager(want, SEED, 5)
    fv.span_graph.run_uncaptured(got, SEED, 5)
    assert torch.equal(got, want)
    assert not torch.equal(got, x0)


@pytest.mark.parametrize("kind,model,kw", SPAN_CASES, ids=SPAN_IDS)
def test_static_spans_compose_into_the_straight_run(graph, kind, model, kw):
    fv = _trainer(graph, kind, model, kw)
    x0 = fv.init_embedding(seed=SEED)
    want, got = x0.clone(), x0.clone()
    fv._run_span_eager(want, SEED, 6)
    done = 0
    for k in (1, 3, 2):
        fv.span_graph.run_uncaptured(got, SEED, k, done)
        done += k
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind,model,kw", SPAN_CASES, ids=SPAN_IDS)
def test_static_span_resumed_from_a_checkpoint(graph, kind, model, kw,
                                                tmp_path):
    fv = _trainer(graph, kind, model, kw)
    x0 = fv.init_embedding(seed=SEED)
    want = x0.clone()
    fv._run_span_eager(want, SEED, 6)
    x = x0.clone()
    fv.span_graph.run_uncaptured(x, SEED, 3)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, _emb(fv, x), 3, {"seed": SEED, "dim": DIM})
    emb, at = load_checkpoint(path)
    x = fv.pad_embedding(emb)
    fv.span_graph.run_uncaptured(x, SEED, 6 - at, at)
    # the checkpoint holds the real rows; the padding rows restart at 0,
    # and no real row reads them
    assert torch.equal(_emb(fv, x), _emb(fv, want))


@pytest.mark.parametrize("kind", ("sync", "batch"))
def test_run_span_on_the_cpu_is_the_eager_loop(graph, kind):
    fv = _trainer(graph, kind, "fr", {})
    x0 = fv.init_embedding(seed=SEED)
    want, got = x0.clone(), x0.clone()
    fv._run_span_eager(want, SEED, 4)
    assert fv.run_span(got, SEED, 4) is got
    assert torch.equal(got, want)
    assert fv.span_graph.captures == 0 and not fv.span_graph.graphs


def test_the_step_buffer_holds_step_at_for_each_iteration(graph):
    fv = SyncForce2Vec(graph, _config("fr", "bfloat16"), device="cpu")
    for it in (0, 1, 2, 500):
        fv._prepare_iteration(SEED, it)
        assert float(fv._step_buf.tensor) == step_at(get_model("fr"), fv.lr,
                                                     it, torch.bfloat16)


def test_the_step_buffer_fills_only_when_the_step_changes():
    buf = StepBuffer("cpu")
    assert buf.write(0.02) is buf.tensor and float(buf.tensor) == np.float32(
        0.02)
    buf.tensor.zero_()  # a write of the value it holds fills nothing
    buf.write(0.02)
    assert float(buf.tensor) == 0.0
    buf.write(0.0199)
    assert float(buf.tensor) == np.float32(0.0199)
