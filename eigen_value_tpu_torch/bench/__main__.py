"""Benchmark CLI: ``python -m eigen_value_tpu_torch.bench --suite
{e2e,kernels,vector,operator,batched,sharded,multihost,large,drift,calibrate,
model,native,all} [--dims 8192 ...] [--sizes 65536 ...] [--backends
matvec_pallas ...] [--batch 256] [--windows 10] [--gap-s 20] [--reps 5]
[--json]`` (also ``python -m eigen_value_tpu_torch``).

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
2048); for ``large`` one ``[large:row] n x n: ms dev, rounds, lam`` line
per row (32768² f32, 65536² bf16); for ``drift`` one line per window
(``--windows``, ``--gap-s``; µs per pass, GB/s, the card's SM clock, power
and temperature) and the spread; for ``calibrate`` the measured and
predicted all-gathers of loopback gloo and the fit; for ``model`` the
scaling model's prediction and sensitivity tables (no device); for
``native`` the native C++ runtime's rows (the CPU; no card needed); or one
JSON object per row with ``--json`` (RFC-valid: nulls, never NaN).
``all`` runs the first three, as in the JAX CLI.  Every suite but
``model`` and ``native`` measures the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys

SUITES = [
    "e2e", "kernels", "vector", "sharded", "multihost", "native", "model",
    "calibrate", "drift", "operator", "batched", "large", "all",
]
#: The suites that run here (every one of the JAX CLI's); ``all`` is the
#: first three, as in the JAX CLI.
PORTED = tuple(SUITES)
#: The suites that need no card: the model computes, the native runtime runs
#: on the CPU.
CARD_FREE = ("model", "native")


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


def _fmt_native(rows) -> str:
    out = []
    for r in rows:
        if r["bench"] == "native_kernel":
            out.append(f"{r['kernel']:<24} {r['dim']:<6}{r['ms'] * 1e3:>12.1f} us   [native C++]")
        else:
            out.append(
                f"[{r['backend']}] {r['dim']:<5} x {r['dim']:>5}\t{r['ms']:>10.3f} ms"
                f"\t\t{r['rounds']:>6} round(s)   [native C++]"
            )
    return "\n".join(out)


def _fmt_large(rows) -> str:
    out = []
    for r in rows:
        if "error" in r:
            out.append(f"[large:{r['backend']}] ERROR: {r['error']}")
        elif "skipped" in r:
            out.append(f"[large:{r['backend']}] {r['dim']} x {r['dim']}: skipped: {r['skipped']}")
        else:
            dev = ("below chain resolution" if r["device_ms"] is None
                   else f"{r['device_ms']:.1f} ms dev")
            out.append(
                f"[large:{r['backend']}] {r['dim']} x {r['dim']}: {dev}, "
                f"{r['rounds']} round(s), lam {r['eigenvalue']:.5f}"
                + ("" if r["rounds_ok"] else "   [CHECK FAILED]")
            )
    return "\n".join(out)


def _fmt_model(rows, sens) -> str:
    gb = [r["ici_gbps"] for r in sens]
    lat = [r["ici_latency_us"] for r in sens]
    out = ["Predicted multi-chip scaling (ANALYTICAL MODEL anchored to"
           " measured 1-chip numbers — not a measurement)\n"]
    for r in rows:
        head = f"[{r['solver']}] {r['dim']}² on {r['chips']:>3} chip(s) / {r['hosts']:>2} host(s): "
        if r["round_us"] is None:
            out.append(head + "not measured (the spec's DCN)")
            continue
        out.append(head + f"{r['round_us']:>9.1f} us/round, eff {r['efficiency'] * 100:5.1f}%")
    out.append(
        "\nSensitivity of predicted efficiency to the UNVALIDATED"
        f" ici parameters (bandwidth {min(gb):g}-{max(gb):g} GB/s, latency"
        f" {min(lat):g}-{max(lat):g} us):"
    )
    for r in sens:
        eff = "not measured" if r["efficiency"] is None else f"{r['efficiency'] * 100:5.1f}%"
        out.append(
            f"[{r['solver']}] {r['dim']}² on {r['chips']:>3} chips: "
            f"ici {r['ici_gbps']:>5.0f} GB/s, {r['ici_latency_us']:>4.1f} us"
            f" -> eff {eff}"
        )
    return "\n".join(out)


def _fmt_calibrate(rows) -> str:
    out = []
    for r in rows:
        if r["bench"] in ("model_calibration", "model_calibration_crossP"):
            ratio = r["ratio"]
            ratio_s = f"{ratio:.2f}" if ratio is not None else "n/a"
            cross = (
                f" [cross-P: fitted on {r['fitted_on_chips']} shards]"
                if r["bench"] == "model_calibration_crossP"
                else ""
            )
            out.append(
                f"all_gather n={r['dim']:>7} over {r['chips']} shards: "
                f"measured {r['measured_us']:>9.1f} us, "
                f"model (gloo-fitted spec) {r['predicted_us']:>9.1f} us, "
                f"ratio {ratio_s}{cross}"
            )
        else:
            # fit_gbps is None where the slope is unresolvable (latency-dominated)
            gbps = r["fit_gbps"]
            gbps_s = (f"{gbps:.3f} GB/s" if gbps is not None
                      else "unresolvable (latency-dominated)")
            out.append(f"fitted gloo exchange: {gbps_s}, {r['fit_latency_us']:.1f} us/step")
    return "\n".join(out)


def _fmt_drift(rows) -> str:
    out = []
    for r in rows:
        if r["bench"] == "drift":
            gbps = r["gbps"]
            gbps_s = f"{gbps:>7.0f} GB/s" if gbps is not None else "   n/a"
            sus = f"  [SUSPECT: {r['suspect_reason']}]" if r["suspect"] else ""
            card = "  ".join(
                "n/a" if r[key] is None else f"{r[key]:.0f} {unit}"
                for key, unit in (("sm_mhz", "MHz"), ("power_w", "W"), ("temp_c", "C")))
            out.append(
                f"t+{r['t_s']:>6.1f}s  window {r['window']:>2}: "
                f"{r['ms'] * 1e3:>8.1f} us/pass  {gbps_s}{sus}  [{card}]"
            )
        else:
            sp = r["spread_pct"]
            sp_s = f"{sp:.1f}%" if sp is not None else "n/a"
            out.append(
                f"spread over {r['windows']} windows: {sp_s} "
                f"(>5% = the card's state drifted; cross-run absolute"
                f" comparisons invalid)"
            )
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eigen_value_tpu_torch.bench")
    p.add_argument("--suite", choices=SUITES, default="kernels")
    p.add_argument("--dims", type=int, nargs="*", help="matrix dims to sweep")
    p.add_argument("--sizes", type=int, nargs="*",
                   help="vector sizes for --suite vector (default 2^16..2^25)")
    p.add_argument("--backends", nargs="*", help="e2e backends to run")
    p.add_argument("--batch", type=int,
                   help="batch size for --suite batched (default 256, config 4)")
    p.add_argument("--windows", type=int, default=10,
                   help="measurement windows for --suite drift")
    p.add_argument("--gap-s", type=float, default=20.0,
                   help="seconds between drift windows")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--json", action="store_true", help="emit JSON lines")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from . import suite

    running = dist.is_initialized()  # a caller's group stays the caller's

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
    if args.suite == "large":
        rows = suite.bench_large(reps=args.reps)
        tables.append((rows, _fmt_large(rows)))
    if args.suite == "drift":
        rows = suite.bench_drift(dim=(args.dims or [8192])[0], windows=args.windows,
                                 gap_s=args.gap_s)
        tables.append((rows, _fmt_drift(rows)))
    if args.suite == "calibrate":
        rows = suite.bench_exchange_calibration(dim=(args.dims or [8192])[0], reps=args.reps)
        tables.append((rows, _fmt_calibrate(rows)))
    if args.suite == "model":
        from ..utils.scaling_model import DEFAULT_SPEC, prediction_table, sensitivity_table

        rows = prediction_table(dims=args.dims or [8192, 32768, 65536])
        # the cards of one host: the H100 spec's DCN is not measured, so a
        # mesh across hosts predicts nothing; the measured latency is swept too
        sens = sensitivity_table(chip_counts=(4, 8),
                                 lat_vals=(0.5, 1.0, 5.0, 25.0, DEFAULT_SPEC.ici_latency_us))
        tables.append((rows + sens, _fmt_model(rows, sens)))
    if args.suite == "native":
        rows = suite.bench_native(dims)
        tables.append((rows, _fmt_native(rows)))
    if dist.is_initialized():  # the sharded suite's group: one table a group
        rank = dist.get_rank()
        if not running:
            dist.destroy_process_group()
        if rank != 0:
            return 0
    if args.json:
        for rows, _ in tables:
            for r in rows:
                print(json.dumps(r, allow_nan=False))
    else:
        if args.suite == "model":
            from ..utils.scaling_model import DEFAULT_SPEC

            print(f"spec: {DEFAULT_SPEC} (utils/scaling_model.py H100_SPEC; None = not measured)")
        elif args.suite == "native":
            print("device: cpu (the native C++ runtime)")
        else:
            import torch

            print(f"device: {torch.cuda.get_device_name(0)}")
        for _, table in tables:
            print(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
