"""The readings that a cell's limits are set from (``limits/<cell>.json``).

    python -m evbench.calibrate --workload <name> --seeds 1 2 ... \\
        [--control-seeds 3 4 5] [--passes 2] [--out FILE]

For each seed of ``--seeds``: the cell's pool made from the seed, every
matrix solved ``--passes`` times through the cell's own call (the timed
path at the timed sizes), the reference on each, and the compared numbers
(``compare.numbers``) as one JSON line: the program's readings.  For each
seed of ``--control-seeds``: the reference with its product one precision
below the configuration's, each control the limits file names
(``controls``: ``reference.CONTROLS``), in the program's place: the
control's readings, which the limits have to fail.  The last line gives the
largest program reading and the smallest control reading of each number.
The benchmark's own runs never run this.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import compare, reference
from .catalog import Catalog
from .pool import make_pool
from .run import Recorder


def program_readings(cat, workload: str, seed: int, passes: int, device) -> dict:
    cell = cat.workload(workload)
    config, traffic = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    pool = make_pool(config, traffic["pool"], seed, device)
    call = Recorder(cat.call_kind(traffic["call"]).start(config, traffic, pool), seed)
    answers = [a for k in range(passes * len(pool)) for a in call(k)]
    refs = [reference.solve(A, config["eps"], config["max_itr"]) for A in pool]
    out = compare.numbers(answers, call.kept(), refs)
    out.update(rounds=[r.rounds for r in refs], stop_margin=min(r.stop_margin for r in refs))
    return out


def control_readings(cat, workload: str, seed: int, kind: str, device) -> dict:
    cell = cat.workload(workload)
    config, traffic = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    pool = make_pool(config, traffic["pool"], seed, device)
    eps, max_itr = config["eps"], config["max_itr"]
    refs, answers = [], []
    for p, A in enumerate(pool):
        refs.append(reference.solve(A, eps, max_itr))
        c = reference.solve_control(A, kind, eps, max_itr)
        answers.append(compare.Answer(p, c.eigenvalue, c.rounds, c.converged, c.eigenvector))
    out = compare.numbers(answers, answers, refs)
    out.update(rounds=[a.rounds for a in answers])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m evbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--passes", type=int, default=2)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("evbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cat = Catalog()
    limits = cat.limits(args.workload)
    lines = []

    def emit(rec: dict) -> None:
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    for seed in args.seeds:
        emit(dict(workload=args.workload, side="program", seed=seed,
                  **program_readings(cat, args.workload, seed, args.passes, device)))
    for kind in limits.get("controls", []):
        for seed in args.control_seeds:
            emit(dict(workload=args.workload, side=f"control:{kind}", seed=seed,
                      **control_readings(cat, args.workload, seed, kind, device)))
    summary = {"workload": args.workload, "limits": {k: limits[k] for k in compare.NUMBERS}}
    for side in sorted({r["side"] for r in lines}):
        rows = [r for r in lines if r["side"] == side]
        pick = max if side == "program" else min
        summary[side] = {k: pick(r[k] for r in rows) for k in compare.NUMBERS + ("lam_rel", "ev_rel")}
    emit(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
