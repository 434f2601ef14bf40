"""One run of one cell: set-up, the measured window, the traced slices,
the check against the plain reference, and the result line.

    python -m evbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

* Set-up (``setup_s``): from the start of the process through the imports,
  the CUDA context, the pool made on the card from ``--seed``, and one
  call on each pool matrix (the kernels' build on a checkout's first run).
* The window: a closed loop of one caller, each call started when the last
  one's answer has reached the host, until ``--seconds`` have passed.
* ``--trace 1``: after the window, twice the traffic's ``trace_calls`` more
  calls under the profiler, first with the device alone traced, then with
  the host's operations too (``trace.py``).
* Then the card's state (nvidia-smi) on a line of its own, the reference on
  the pool (``reference.py``, after the program's peak memory is read),
  and the comparison (``compare.py``).

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted`` (the calls timed), ``failed`` (the answers that fail a
limit), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics, each read by ``metrics/<name>.py``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each compared number
with its limit, also printed as the last lines of standard error.

Exits non-zero and prints no result when there is no CUDA card (or fewer
than the cell asks for), and when a module of ``jax``, ``jaxlib``,
``flax`` or ``eigen_value_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import random
import subprocess
import sys
import time
from typing import Dict, List, Optional

#: Top-level module names the benchmark may never load.
FORBIDDEN = ("jax", "jaxlib", "flax", "eigen_value_tpu")
#: Calls on the traced slice's first calls that the profiler sees but the
#: slice does not count.
TRACE_WARM = 2
#: Answers whose eigenvector is kept for the check besides the last on
#: each matrix.
SAMPLE = 8


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``)."""

    config: dict
    traffic: dict
    setup_s: float
    #: ``(t0, t1, answers)`` of each call of the window, host clock
    records: list
    window_s: float
    peak_bytes: int
    #: the reference's solution of each pool matrix
    refs: list
    card: str
    slice: Optional[object] = None  # trace.Slice with --trace 1

    @property
    def answers(self):
        return [a for _, _, answers in self.records for a in answers]

    @property
    def itemsize(self) -> int:
        from .pool import storage_dtype

        return storage_dtype(self.config).itemsize

    @property
    def symmetric(self) -> bool:
        return bool(self.traffic.get("solver", {}).get("symmetric", False))


class Recorder:
    """``call(k)`` whose answers keep no eigenvector, but for the last on
    each matrix and a sample of :data:`SAMPLE` answers drawn from the seed
    (reservoir sampling over every answer recorded)."""

    def __init__(self, call, seed: int):
        self.call = call
        self.last: Dict[int, object] = {}
        self.sample: list = []
        self.seen = 0
        self.rng = random.Random(seed)

    def __call__(self, k: int) -> list:
        out = []
        for a in self.call(k):
            self.last[a.matrix] = a
            if len(self.sample) < SAMPLE:
                self.sample.append(a)
            else:
                j = self.rng.randrange(self.seen + 1)
                if j < SAMPLE:
                    self.sample[j] = a
            self.seen += 1
            out.append(a._replace(eigenvector=None))
        return out

    def kept(self) -> list:
        """The answers whose eigenvector was kept."""
        return list(self.last.values()) + self.sample

    def restart(self) -> None:
        """Forget the warm calls' answers: the sample is of the timed ones."""
        self.last.clear()
        self.sample.clear()
        self.seen = 0


def window(call, seconds: float) -> tuple:
    """Back-to-back calls until ``seconds`` have passed: ``(start, records)``."""
    records, k = [], 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        answers = call(k)
        t1 = time.perf_counter()
        records.append((t0, t1, answers))
        k += 1
        if t1 - start >= seconds:
            return start, records


def card_state() -> dict:
    """The card's name, power limit, SM clock, temperature and power draw
    by nvidia-smi ({} where it cannot be read)."""
    fields = ["name", "power.limit", "clocks.sm", "temperature.gpu", "power.draw"]
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    first = out.splitlines()[:1]
    return dict(zip(fields, (v.strip() for v in first[0].split(",")))) if first else {}


def run_cell(cat, workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float, log=print) -> dict:
    """One run of ``workload`` on ``device``; the result object."""
    import torch

    from . import compare, reference, roofline
    from .pool import make_pool
    from .trace import profile_slice

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    cell = cat.workload(workload)
    config = cat.config(cell["config"])
    traffic = cat.traffic(cell["traffic"])
    limits = cat.limits(workload)
    kind = cat.call_kind(traffic["call"])  # imports the program
    marks = [("imports", time.perf_counter())]
    torch.empty(1, device=device)
    sync()
    marks.append(("device context", time.perf_counter()))
    pool = make_pool(config, traffic["pool"], seed, device)
    sync()
    marks.append(("pool", time.perf_counter()))
    call = Recorder(kind.start(config, traffic, pool), seed)
    for k in range(len(pool)):
        call(k)
    sync()
    call.restart()
    marks.append(("warm calls", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    log("set-up s: " + ", ".join(f"{what} {t - prev:.3f}" for (what, t), prev
                                 in zip(marks, [t0] + [t for _, t in marks])), file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    gc.freeze()  # the set-up's objects: never rescanned by the window's collections

    start, records = window(call, seconds)
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window_s = records[-1][1] - start
    eighths = [records[len(records) * q // 8:len(records) * (q + 1) // 8] for q in range(8)]
    log("window: ms a call by eighth " + " ".join(
        f"{1e3 * (part[-1][1] - part[0][0]) / len(part):.6f}" for part in eighths if part),
        file=sys.stderr)
    slc = labelled = None
    if trace:
        calls = traffic["trace_calls"]
        slc = profile_slice(call, len(records), calls, TRACE_WARM, sync, host=False)
        labelled = profile_slice(call, len(records) + calls + TRACE_WARM, calls, TRACE_WARM,
                                 sync, host=True)
        untraced = window_s / len(records)
        for what, s in (("device alone", slc), ("device and host", labelled)):
            traced = sum(t1 - t0_ for t0_, t1, _ in s.records) / len(s.records)
            log(f"traced slice ({what}): {len(s.records)} calls after {TRACE_WARM} uncounted, "
                f"span {s.span_us / 1e6!r} s, busy {s.busy_us / 1e6!r} s; host s a call "
                f"{traced!r} against {untraced!r} in the window ({100 * (traced / untraced - 1):+.2f}%)",
                file=sys.stderr)

    card = card_state() if cuda else {}
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    log(json.dumps({"card": card, "published_peaks": roofline.peaks(name)}))
    refs = [reference.solve(A, config["eps"], config["max_itr"]) for A in pool]
    answers = [a for _, _, ans in records for a in ans]
    for s in (slc, labelled):
        if s is not None:
            answers += [a for _, _, ans in s.records for a in ans]
    values = compare.numbers(answers, call.kept(), refs)
    correct, checks = compare.judge(values, limits)
    log(f"lam_rel {values['lam_rel']!r} ev_rel {values['ev_rel']!r} (the parts of pair_rel)",
        file=sys.stderr)
    log(json.dumps({"reference": [dict(rounds=r.rounds, converged=r.converged,
                                       eigenvalue=r.eigenvalue, stop_margin=r.stop_margin)
                                  for r in refs]}), file=sys.stderr)

    run = Run(config, traffic, setup_s, records, window_s, peak, refs, name, slc)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry in cat.metrics_for(workload, section):
        value = cat.metric(entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": name, "count": cell["chips"],
           "memory_peak_bytes": max(setup_peak, peak)}
    result = {"correct": correct, "attempted": len(records),
              "failed": compare.wrong_answers(answers, refs, limits),
              "metrics": metrics, "device": dev}
    if slc is not None:
        dev["busy_s"] = slc.busy_us / 1e6
        dev["window_s"] = slc.span_us / 1e6
        result["breakdown"] = {"device_ops": [list(kv) for kv in slc.by_name()[:10]],
                               "idle_gaps": [list(kv) for kv in labelled.idle_by_host()[:10]]}
    # a number that is not finite (a broken solve) is written as null: JSON has no inf
    result["checks"] = {c["name"]: {"value": c["value"] if math.isfinite(c["value"]) else None,
                                    "limit": c["limit"]} for c in checks}
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    parser = argparse.ArgumentParser(prog="python -m evbench", description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from .catalog import Catalog

    cat = Catalog()
    chips = cat.workload(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"evbench: {args.workload} needs {chips} CUDA card(s), found {found}; "
              f"no result", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result = run_cell(cat, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t0)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"evbench: forbidden modules loaded: {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] is not None and c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    return 0
