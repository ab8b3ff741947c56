"""Where a cell's parts live, found by the names in ``BENCHMARK.json``.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a
configuration and a traffic mix.  Each part is a file of its own, so that
a cell, a configuration, a traffic mix or a per-layer metric is added by
adding files:

* the configuration: the file its ``configs`` entry names
  (``portbench/configs/<config>.json``);
* the traffic mix: ``portbench/traffic/<traffic>.json``, the schedule,
  sampling and type flags of the command line that trains the graph;
* the cell's correctness limits: ``portbench/cells/<cell>.json``, each
  limit with the readings it was set from;
* a per-layer metric's reader: ``portbench/metrics/<metric>.py``, whose
  ``read(ctx)`` returns the metric's value, or None where its run holds
  nothing to read;
* the model's part of the reference: ``portbench/reference/models/
  <model>.py`` (``reference/force2vec.py``'s ``model``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HARNESS = Path(__file__).resolve().parent
ROOT = HARNESS.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json's metric entries this cell reports
    per_layer: list
    root: Path = ROOT  # the checkout the cell was read from


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError``
    if the file has no such cell or configuration."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{', '.join(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    harness = root / HARNESS.name
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((root / configs[w["config"]]["file"]).read_text()),
        traffic=json.loads(
            (harness / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads(
            (harness / "cells" / f"{name}.json").read_text())["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root,
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / HARNESS.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
