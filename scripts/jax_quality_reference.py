"""The JAX package's own quality after 50 sync iterations on the bench graph,
run on the CPU: the reference values behind ``chip_smoke.py``'s margins.

    JAX_PLATFORMS=cpu python3 scripts/jax_quality_reference.py [--iters 50]
        [--seed 1] [--only NAME] [--json PATH]

For each of the three sync configurations that ``chip_smoke.py`` trains
(``bench.py``'s graph, dim 128, ns 5, bf16 gathers, min_width 8,
hub_width 128) it trains the JAX package with its threefry draws and prints
the statistic ``chip_smoke.py`` checks, over the same 100,000 random pairs:

* ``tdist`` with 256-row group-shared negatives (``-option 5``) and
  ``tdist_per_vertex`` (``-option 5 -bs 1``): mean random-pair minus mean
  edge distance;
* ``rwalk`` (``-option 7``), a sigmoid model: mean ``x_i . x_j`` over
  edges minus over random pairs, the quantity its forces optimise; the
  distance gap too, for the record.

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
from force2vec_tpu.train.trainer import TrainConfig  # noqa: E402

PAIRS = 100_000  # chip_smoke.QUALITY_PAIRS, drawn the same way
CONTROL_SEED = 0  # chip_smoke.CONTROL_SEED
RECON_VERTICES = 1000
BASE = TrainConfig(dim=128, model="tdist", ns=5, batch_size=256,
                   gather_dtype="bfloat16")
CONFIGS = {
    "tdist": BASE,
    "tdist_per_vertex": dataclasses.replace(BASE, per_vertex_samples=True),
    "rwalk": dataclasses.replace(BASE, model="rwalk"),
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
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--only", choices=sorted(CONFIGS), default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    graph = bench_graph()
    res = {"iters": args.iters, "seed": args.seed, "pairs": PAIRS,
           "device": "cpu (JAX)"}
    for name, cfg in CONFIGS.items():
        if args.only and name != args.only:
            continue
        t0 = time.perf_counter()
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
