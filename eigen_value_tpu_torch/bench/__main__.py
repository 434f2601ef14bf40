"""Benchmark CLI: ``python -m eigen_value_tpu_torch.bench --suite kernels
[--dims 8192 ...] [--json]``.

Prints the JAX CLI's per-kernel table (one block per kernel, ``dim   us
GB/s   % roofline`` rows), or one JSON object per row with ``--json``.
Only the ``kernels`` suite is ported; the other suite names of the JAX CLI
are accepted and raise, naming the ROADMAP item that holds them.
"""

from __future__ import annotations

import argparse
import json
import sys

SUITES = [
    "e2e", "kernels", "vector", "sharded", "multihost", "native", "model",
    "calibrate", "drift", "operator", "batched", "large", "all",
]


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eigen_value_tpu_torch.bench")
    p.add_argument("--suite", choices=SUITES, default="kernels")
    p.add_argument("--dims", type=int, nargs="*", help="matrix dims to sweep")
    p.add_argument("--json", action="store_true", help="emit JSON lines")
    args = p.parse_args(argv)
    if args.suite != "kernels":
        raise SystemExit(
            f"--suite {args.suite} is not ported to eigen_value_tpu_torch yet "
            f"(ROADMAP: Queue 1 item 13); only 'kernels' runs"
        )

    from . import suite

    rows = suite.bench_kernels(args.dims or suite.MATRIX_DIMS)
    if args.json:
        for r in rows:
            print(json.dumps(r, allow_nan=False))
    else:
        import torch

        print(f"device: {torch.cuda.get_device_name(0)}")
        print(_fmt_kernels(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
