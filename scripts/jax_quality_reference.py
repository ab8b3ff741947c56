"""The JAX package's own quality on the bench graph, run on the CPU: the
reference values behind ``chip_smoke.py``'s margins.

    JAX_PLATFORMS=cpu python3 scripts/jax_quality_reference.py [--iters 50]
        [--batch-iters 20] [--seed 1] [--only NAME ...] [--json PATH]

For each of the five dim-128 sync configurations that ``chip_smoke.py``
trains (``bench.py``'s graph, ns 5, bf16 gathers, min_width 8,
hub_width 128; ``--iters`` iterations) it trains the JAX package with its
threefry draws and prints the statistic ``chip_smoke.py`` checks, over the
same 100,000 random pairs:

* ``tdist`` with 256-row group-shared negatives (``-option 5``),
  ``tdist_per_vertex`` (``-option 5 -bs 1``) and ``fr`` (``-option 2``):
  mean random-pair minus mean edge distance;
* ``rwalk`` (``-option 7``) and ``sigmoid`` (``-option 6``), the sigmoid
  models: mean ``x_i . x_j`` over edges minus over random pairs, the
  quantity their forces optimise; the distance gap too, for the record.

``tdist_batch`` is the batch-sequential trainer (``Force2Vec``) as the
command line runs it by default and ``chip_smoke.py`` path E runs the
port's: ``-option 5 -batch 256 -dim 128`` (ns 5, f32 gathers),
``--batch-iters`` iterations; its distance gap.

``tdist_vertex`` and ``tdist_vertex_pool`` are the vertex-sharded schedule
(``VertexShardedForce2Vec``) on one device, as ``chip_smoke.py`` path F1
trains the port's: tdist, dim 128, ns 5, f32 (the schedule ignores the
gather dtype), min_width 8, hub_width 128, ``shared`` sampling and
``pool`` sampling with a 128-row pool; ``--iters`` iterations; their
distance gaps.

``tdist_x_bf16``, ``tdist_per_vertex_x_bf16`` and ``tdist_batch_x_bf16``
are ``tdist``, ``tdist_per_vertex`` and ``tdist_batch`` with X itself held
in bf16 (``TrainConfig(dtype="bfloat16")``, no separate gather replica), as
``chip_smoke.py`` path I3 trains the port's.

``tdist_d32``, ``tdist_per_vertex_d256``, ``rwalk_d100`` and ``fr_d2``
are the sync configurations of ``chip_smoke.py`` path G2, at the bench
configuration with the width changed: tdist at dim 32, tdist ``-bs 1`` at
dim 256, rwalk at dim 100 and fr at dim 2; each the statistic of its
model, as above.

For ``tdist`` it also scores the trained X as ``chip_smoke.py``'s path D
does, with the JAX package's evaluation (scikit-learn): link-prediction
scores (``link_prediction_scores``, Hadamard features, seed 0) and
``graph_reconstruction_accuracy(num_vertices=1000)``, for the trained X and
for a random-normal control X of the same shape
(``np.random.default_rng(CONTROL_SEED)``, as path D draws it).

Needs JAX and scikit-learn and takes a few minutes of CPU; it never runs on
the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from force2vec_tpu.eval.linkpred import link_prediction_scores  # noqa: E402
from force2vec_tpu.eval.reconstruction import (  # noqa: E402
    graph_reconstruction_accuracy)
from force2vec_tpu.train.sync import SyncForce2Vec  # noqa: E402
from force2vec_tpu.train.trainer import Force2Vec, TrainConfig  # noqa: E402

PAIRS = 100_000  # chip_smoke.QUALITY_PAIRS, drawn the same way
CONTROL_SEED = 0  # chip_smoke.CONTROL_SEED
RECON_VERTICES = 1000
BASE = TrainConfig(dim=128, model="tdist", ns=5, batch_size=256,
                   gather_dtype="bfloat16")
CONFIGS = {
    "tdist": BASE,
    "tdist_per_vertex": dataclasses.replace(BASE, per_vertex_samples=True),
    "rwalk": dataclasses.replace(BASE, model="rwalk"),
    "sigmoid": dataclasses.replace(BASE, model="sigmoid"),
    "fr": dataclasses.replace(BASE, model="fr"),
    # the batch schedule at the command line's defaults (no --gather-dtype)
    "tdist_batch": TrainConfig(dim=128, model="tdist", ns=5, batch_size=256),
    # the vertex schedule on one device, both sampling modes
    "tdist_vertex": BASE,
    "tdist_vertex_pool": BASE,
    # chip_smoke.py path G2: the sync schedule at other widths
    "tdist_d32": dataclasses.replace(BASE, dim=32),
    "tdist_per_vertex_d256": dataclasses.replace(BASE, dim=256,
                                                 per_vertex_samples=True),
    "rwalk_d100": dataclasses.replace(BASE, dim=100, model="rwalk"),
    "fr_d2": dataclasses.replace(BASE, dim=2, model="fr"),
    # chip_smoke.py path I3: X itself held in bf16 (the gathers read X)
    "tdist_x_bf16": dataclasses.replace(BASE, dtype="bfloat16",
                                        gather_dtype=None),
    "tdist_per_vertex_x_bf16": dataclasses.replace(
        BASE, dtype="bfloat16", gather_dtype=None, per_vertex_samples=True),
    "tdist_batch_x_bf16": TrainConfig(dim=128, model="tdist", ns=5,
                                      batch_size=256, dtype="bfloat16"),
}


def bench_graph():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.synth_powerlaw_graph()


def _means(emb, a, b, chunk=1 << 18):
    """Mean distance and mean dot product over the pairs (a, b), in f64."""
    dist = dot = 0.0
    for i in range(0, a.size, chunk):
        xa, xb = emb[a[i:i + chunk]], emb[b[i:i + chunk]]
        dist += float(np.linalg.norm(xa - xb, axis=1).sum())
        dot += float(np.einsum("ij,ij->i", xa, xb).sum())
    return dist / a.size, dot / a.size


def stats(graph, emb) -> dict:
    """Distance and dot-product gaps, as ``chip_smoke.quality`` takes them."""
    emb = emb.astype(np.float64)
    src = np.repeat(np.arange(graph.n), graph.degrees)
    dst = graph.colids.astype(np.int64)
    rng = np.random.default_rng(0)
    a = rng.integers(0, graph.n, PAIRS)
    b = rng.integers(0, graph.n, PAIRS)
    d_edge, dot_edge = _means(emb, src, dst)
    d_rand, dot_rand = _means(emb, a, b)
    return {"d_edge": d_edge, "d_rand": d_rand, "dist_gap": d_rand - d_edge,
            "dot_edge": dot_edge, "dot_rand": dot_rand,
            "dot_gap": dot_edge - dot_rand}


def eval_stats(graph, emb) -> dict:
    """Link-prediction scores and reconstruction accuracy of ``emb`` and of
    the random-normal control, as ``chip_smoke.py``'s path D takes them."""
    control = np.random.default_rng(CONTROL_SEED).standard_normal(
        emb.shape).astype(np.float32)
    out = {}
    for what, x in (("trained", emb), ("control", control)):
        t0 = time.perf_counter()
        out[f"linkpred_{what}"] = link_prediction_scores(graph, x)
        out[f"recon_{what}"] = graph_reconstruction_accuracy(
            graph, x, num_vertices=RECON_VERTICES)
        out[f"eval_seconds_{what}"] = time.perf_counter() - t0
    out["auc_margin"] = out["linkpred_trained"]["auc"] - 0.5
    out["recon_margin"] = out["recon_trained"] - out["recon_control"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch-iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--only", choices=sorted(CONFIGS), nargs="+",
                    default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    graph = bench_graph()
    res = {"iters": args.iters, "batch_iters": args.batch_iters,
           "seed": args.seed, "pairs": PAIRS, "device": "cpu (JAX)"}
    for name, cfg in CONFIGS.items():
        if args.only and name not in args.only:
            continue
        t0 = time.perf_counter()
        if name.startswith("tdist_batch"):
            emb = Force2Vec(graph, cfg).train(iters=args.batch_iters,
                                              seed=args.seed)
        elif name.startswith("tdist_vertex"):
            from force2vec_tpu.dist.vertex_sharded import (
                VertexShardedForce2Vec, make_vp_mesh)

            fv = VertexShardedForce2Vec(
                graph, cfg, mesh=make_vp_mesh(jax.devices()[:1]),
                min_width=8, hub_width=128,
                sampling="pool" if name.endswith("pool") else "shared")
            emb = fv.train(iters=args.iters, seed=args.seed)
        else:
            fv = SyncForce2Vec(graph, cfg, min_width=8, hub_width=128,
                               use_pallas=False)
            emb = fv.train(iters=args.iters, seed=args.seed)
        res[name] = {**stats(graph, emb), "finite": bool(np.isfinite(emb).all()),
                     "seconds": time.perf_counter() - t0}
        if name == "tdist":
            res[name].update(eval_stats(graph, np.asarray(emb)))
        print(name, json.dumps(res[name]), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
