"""The readings a cell's correctness limits are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 1,2,3] [--out PATH]

For each seed: the run's set-up and checked iterations as ``run.py``
makes them (``run.set_up``), the program freed, the reference's run and
the comparison (``run.check_run``): the sound runs, whose largest reading
of each number is its lower reading.  For each control seed the same with
the control in the program's place: the program with X held in bfloat16,
the next precision below the configuration's float32 (``TrainConfig(dtype=
"bfloat16")``, the program's own path); its smallest reading is the upper
one.  For each fault seed (each one of the sound seeds), the reference
with a layer broken put in the program's place (``FAULTS``): the
repulsion left out, or halved where a negative is not (nearly) the row
itself, the attraction of the hub rows (degree above 256) left out, the
replica's rounding left out.  One JSON line a run, and the summary last;
``--out`` writes them all.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check, run, spec
from portbench.reference import force2vec


class _NoRepulsion(force2vec.Reference):
    """No negative adds a force."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.repulsion = lambda xi, s, step: torch.zeros_like(xi - s)


class _HalfRepulsion(force2vec.Reference):
    """Every negative's force halved, except where the negative is the row
    itself or its replica (``|x_i - s|² <= 1e-2``, the force at the clamp):
    the ordinary repulsion off by half, the rare self-drawn negative
    intact."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        whole = self.repulsion

        def half(xi, s, step):
            f = whole(xi, s, step)
            r = ((xi - s) ** 2).sum(dim=-1, keepdim=True)
            return torch.where(r > 1e-2, 0.5 * f, f)
        self.repulsion = half


class _NoHubs(force2vec.Reference):
    """The rows of degree above the sync layout's hub width (256) take no
    attraction."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._hub = self.deg > 256

    def _attraction(self, x, xg, r0, r1):
        out = super()._attraction(x, xg, r0, r1)
        return torch.where(self._hub[r0:r1, None], 0.0, out)


class _NoReplica(force2vec.Reference):
    """Neighbours and negatives gathered from X itself, not its bf16
    replica."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.gather_dtype = None


# the faults a schedule can have: the batch schedule has no replica and
# no hub rows
FAULTS = {"sync": {"no_repulsion": _NoRepulsion,
                   "half_repulsion": _HalfRepulsion, "no_hubs": _NoHubs,
                   "no_replica": _NoReplica},
          "batch": {"no_repulsion": _NoRepulsion,
                    "half_repulsion": _HalfRepulsion}}


def fault_readings(cell: spec.Cell, edges, x0, seed: int, device) -> dict:
    """Each of the cell's ``FAULTS`` put in the program's place: the
    readings of its checked iterations against the reference's."""
    csr = run.reference_csr(cell, edges)
    good = force2vec.build(*csr, cell.config, cell.traffic,
                           device).run(x0, seed, check.CHECKED)
    return {name: check.readings(
                x0, cls(*csr, cell.config, cell.traffic, device).run(
                    x0, seed, check.CHECKED), good, device)
            for name, cls in FAULTS[cell.traffic["schedule"]].items()}


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    lines = []

    def emit(line: dict) -> None:
        lines.append(line)
        print(json.dumps(line), flush=True)

    runs = [(s, "float32") for s in args.seeds] + [
        (s, "bfloat16") for s in args.control_seeds]
    for seed, dtype in runs:
        t = time.perf_counter()
        edges, runner, x, x0, program, spans = run.set_up(cell, seed, "cuda",
                                                          dtype)
        del x, runner
        run.free()
        per_iter = run.check_run(cell, edges, x0, program, seed, "cuda")
        emit({"cell": cell.name, "seed": seed,
              "kind": "sound" if dtype == "float32" else "control",
              "readings": per_iter, "spans": spans,
              "seconds": time.perf_counter() - t})
        if seed in args.fault_seeds and dtype == "float32":
            for name, per in fault_readings(cell, edges, x0, seed,
                                            "cuda").items():
                emit({"cell": cell.name, "seed": seed, "kind": name,
                      "readings": per})
        del edges, x0, program
        run.free()

    summary = {"cell": cell.name,
               "device": torch.cuda.get_device_name(0),
               "power_limit": run.power_limit()}
    kinds = [("sound", max), ("control", min)] + [
        (name, min) for name in FAULTS[cell.traffic["schedule"]]]
    for kind, pick in kinds:
        got = [ln["readings"] for ln in lines if ln["kind"] == kind]
        if got:
            summary[kind] = {k: pick(max(r[k] for r in per) for per in got)
                             for k in check.NUMBERS}
    emit(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(ln) for ln in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
