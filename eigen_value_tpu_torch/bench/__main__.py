"""Benchmark CLI: ``python -m eigen_value_tpu_torch.bench --suite
{e2e,kernels,vector,operator,batched,sharded,multihost,all} [--dims 8192 ...]
[--sizes 65536 ...] [--backends matvec_pallas ...] [--batch 256] [--reps 5]
[--json]``.

Prints the JAX CLI's tables: for ``e2e`` one block per backend of
``dim x dim   ms   rounds   (device ms, chained)`` rows; for ``kernels`` and
``vector`` one block per kernel of ``dim   us   GB/s   % roofline`` rows;
for ``operator`` one ``[rung] dim x dim   device ms (chained)   rounds``
line per row; for ``batched`` one ``[batched] B x n^2: ... solves/s`` line
(``--batch``, and ``--dims`` for the matrix dim; config 4's 256 x 512² by
default); for ``sharded`` one ``[sharded] solver dim x dim  P shards (mesh)
ms  rounds`` line per solver, in the world the CLI was launched in
(``torchrun --nproc_per_node=K -m eigen_value_tpu_torch.bench --suite
sharded``; rank 0 prints; ``--dims`` default 4096); for ``multihost`` one
line per solver and group of ``mh_worker`` processes (``--dims`` default
2048); or one JSON object per row with ``--json`` (RFC-valid: nulls, never
NaN).  ``all`` runs the first three, as in the JAX CLI.  The other
suite names of the JAX CLI are accepted and raise, naming the ROADMAP item
that holds them.
"""

from __future__ import annotations

import argparse
import json
import sys

SUITES = [
    "e2e", "kernels", "vector", "sharded", "multihost", "native", "model",
    "calibrate", "drift", "operator", "batched", "large", "all",
]
#: The suites that run here; ``all`` is the first three, as in the JAX CLI.
PORTED = ("e2e", "kernels", "vector", "operator", "batched", "sharded", "multihost", "all")


def _fmt_e2e(rows) -> str:
    out = []
    backend = None
    for r in rows:
        if r["backend"] != backend:
            backend = r["backend"]
            out.append(f"\nSimilarity Transform (backend: {backend})\n")
        if "skipped" in r:
            out.append(f"{r['dim']:<5} x {r['dim']:>5}\t\tskipped: {r['skipped']}")
            continue
        parity = "" if r["rounds_ok"] else "   [PARITY BREAK]"
        dev = (
            f"{r['device_ms']:.3f} ms"
            if r["device_ms"] is not None
            else "below chain resolution"
        )
        out.append(
            f"{r['dim']:<5} x {r['dim']:>5}\t\t{r['ms']:>10.3f} ms"
            f"\t\t{r['rounds']:>6} round(s)"
            f"\t\t(device {dev}, chained){parity}"
        )
    return "\n".join(out)


def _fmt_kernels(rows, size_key="dim") -> str:
    out = []
    kernel = None
    for r in sorted(rows, key=lambda r: (r["kernel"], r[size_key])):
        if r["kernel"] != kernel:
            kernel = r["kernel"]
            out.append(f"\n{kernel}\n")
        gbps = r.get("gbps")
        gb = f"{gbps:>8.0f} GB/s" if gbps is not None else " " * 13
        roof = r.get("roofline_pct")
        roof_s = f"{roof:>6.1f}% roofline" if roof is not None else ""
        out.append(f"{r[size_key]:<10}\t\t{r['ms'] * 1e3:>10.1f} us\t{gb}\t{roof_s}")
    return "\n".join(out)


def _fmt_operator(rows) -> str:
    out = []
    for r in rows:
        parity = "" if r.get("rounds_ok", True) else "   [PARITY BREAK]"
        dev = (
            f"{r['device_ms']:>10.4f} ms dev (chained)"
            if r["device_ms"] is not None
            else "  below chain resolution  "
        )
        out.append(
            f"[{r['backend']}] {r['dim']:<5} x {r['dim']:>5}\t{dev}"
            f"\t{r['rounds']:>4} round(s){parity}"
        )
    return "\n".join(out)


def _fmt_batched(rows) -> str:
    return "\n".join(
        f"[batched] {r['batch']} x {r['dim']}^2: "
        f"{r['device_ms_per_batch']:.2f} ms/batch dev, "
        f"{r['solves_per_s']:.0f} solves/s, rounds {r['rounds_hist']}, "
        f"max resid {r['max_rel_residual']:.1e}"
        + ("" if r["rounds_ok"] else "   [CHECK FAILED]")
        for r in rows
    )


def _fmt_sharded(rows) -> str:
    return "\n".join(
        f"[{r['bench']}] exchange {r['dim']} / {r['shards']} floats on {r['shards']} shards: "
        + ", ".join(f"{k} {v:.1f} us" for k, v in r["exchange_us"].items())
        if "exchange_us" in r else
        f"[{r['bench']}] {r['solver']:<14} {r['dim']:<5} x {r['dim']:>5}\t"
        f"{r.get('shards', r.get('processes'))} {'shards' if 'shards' in r else 'processes'} "
        f"({r['mesh']})\t{r['ms']:>10.3f} ms\t{r['rounds']:>4} round(s)"
        + ("" if r.get("rounds_ok", True) else "   [PARITY BREAK]")
        + ("" if r.get("scaling_efficiency") is None
           else f"\tefficiency {r['scaling_efficiency']:.3f}")
        for r in rows
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eigen_value_tpu_torch.bench")
    p.add_argument("--suite", choices=SUITES, default="kernels")
    p.add_argument("--dims", type=int, nargs="*", help="matrix dims to sweep")
    p.add_argument("--sizes", type=int, nargs="*",
                   help="vector sizes for --suite vector (default 2^16..2^25)")
    p.add_argument("--backends", nargs="*", help="e2e backends to run")
    p.add_argument("--batch", type=int,
                   help="batch size for --suite batched (default 256, config 4)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--json", action="store_true", help="emit JSON lines")
    args = p.parse_args(argv)
    if args.suite not in PORTED:
        raise SystemExit(
            f"--suite {args.suite} is not ported to eigen_value_tpu_torch yet "
            f"(ROADMAP: Queue 1 item 13); {', '.join(PORTED)} run"
        )

    from . import suite

    unknown = sorted(set(args.backends or ()) - set(suite.E2E_BACKENDS))
    if unknown:
        raise SystemExit(f"unknown e2e backends {unknown}; known: {list(suite.E2E_BACKENDS)}")
    dims = args.dims or suite.MATRIX_DIMS
    tables = []
    if args.suite in ("e2e", "all"):
        rows = suite.bench_e2e(dims, backends=args.backends, reps=args.reps)
        tables.append((rows, _fmt_e2e(rows)))
    if args.suite in ("kernels", "all"):
        rows = suite.bench_kernels(dims)
        tables.append((rows, _fmt_kernels(rows)))
    if args.suite in ("vector", "all"):
        rows = suite.bench_vector_kernels(args.sizes or suite.VECTOR_SIZES)
        tables.append((rows, _fmt_kernels(rows, size_key="size")))
    if args.suite == "operator":
        rows = suite.bench_operator(dims, reps=args.reps)
        tables.append((rows, _fmt_operator(rows)))
    if args.suite == "batched":
        kw = {}
        if args.dims:
            kw["dim"] = args.dims[0]
        if args.batch:
            kw["batch"] = args.batch
        rows = suite.bench_batched(reps=args.reps, **kw)
        tables.append((rows, _fmt_batched(rows)))
    if args.suite == "sharded":
        rows = suite.bench_sharded(dim=args.dims[0] if args.dims else 4096, reps=args.reps)
        tables.append((rows, _fmt_sharded(rows)))
    if args.suite == "multihost":
        rows = suite.bench_multihost(dim=args.dims[0] if args.dims else 2048, reps=args.reps)
        tables.append((rows, _fmt_sharded(rows)))
    import torch.distributed as dist

    if dist.is_initialized():  # the sharded suite's group: one table a group
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank != 0:
            return 0
    if args.json:
        for rows, _ in tables:
            for r in rows:
                print(json.dumps(r, allow_nan=False))
    else:
        import torch

        print(f"device: {torch.cuda.get_device_name(0)}")
        for _, table in tables:
            print(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
