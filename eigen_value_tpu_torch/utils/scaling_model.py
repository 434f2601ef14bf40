"""Analytical scaling model for multi-card solves (counterpart of
``eigen_value_tpu.utils.scaling_model``; pure Python, no device).

The port was measured on a host with one card, so a mesh of several is
PREDICTED from first principles, anchored to measured single-card numbers
— a model, not a measurement.  The per-round cost of the row-partitioned
matvec-form solve (parallel/sharded.py) decomposes as:

  * local compute: the shard's matvec is bound by memory —
    ``(n²/P)·itemsize / hbm_gbps``;
  * exchange: the O(n) scaling vector.
      - gathered form: one all_gather per round — each card receives
        (P−1)/P·n·itemsize over its links (``ici_*``: NVLink within a
        host), plus a per-step latency on the ring of P shards;
      - ring form: P−1 hops of an n/P chunk, each OVERLAPPED with that
        chunk's GEMV — the exchange only costs where a chunk's wire time
        exceeds its compute time (latency-bound small chunks);
  * DCN: when the mesh spans hosts, part of the exchange crosses the host
    network instead (``dcn_*``).  A spec may leave the DCN fields None
    (not measured): every prediction that would need them is then None,
    and the tables say "not measured".

Two specs: ``H100_SPEC`` (the default; each field measured on the card or
cited, with its source) and ``V5E_SPEC``, the JAX package's v5e defaults,
kept so the port's functions can be held to JAX's on the same spec.  Use
``python -m eigen_value_tpu_torch.bench --suite model`` for the prediction
tables.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Hardware parameters.  The field defaults are the JAX package's TPU
    v5e figures (``V5E_SPEC``); ``H100_SPEC`` gives the card's own."""

    hbm_gbps: float = 850.0  # v5e: sustained, measured by the JAX bench (nameplate 819)
    ici_gbps: float = 400.0  # v5e: per-chip aggregate ICI bandwidth
    ici_latency_us: float = 1.0  # v5e: per ppermute/collective step
    dcn_gbps: Optional[float] = 25.0  # v5e: per-host effective DCN bandwidth
    dcn_latency_us: Optional[float] = 10.0  # v5e: per DCN crossing
    itemsize: int = 4  # float32 matrix


#: The JAX package's ``DEFAULT_SPEC`` (a TPU v5e), for parity with its model.
V5E_SPEC = ChipSpec()

#: One NVIDIA H100 SXM in an 8-card NVLink host.
H100_SPEC = ChipSpec(
    # measured: the matvec kernel reads A and ev and writes y, 268.5 MB at
    # 8192², in 0.0893 ms (chip_smoke.py's kernels line, NVIDIA H100 80GB
    # HBM3 at 700.00 W; PERF.md §6)
    hbm_gbps=268.500992e6 / 0.0893e-3 / 1e9,
    # cited: NVLink 4, 900 GB/s a card in both directions together, 450 GB/s
    # each way (NVIDIA H100 Tensor Core GPU data sheet, SXM part)
    ici_gbps=450.0,
    # measured: a one-rank NCCL all-gather of 32 KB with the round's read
    # took 94.9 µs a call, a sum with the read 32.2 µs (bench --suite
    # sharded, NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md §6).  The
    # difference is the host's cost of one collective through
    # torch.distributed and NCCL on one card; it holds no link crossing
    # (two cards were never measured), so it is a floor of the step's
    # latency at P > 1.
    ici_latency_us=94.9 - 32.2,
    # not measured: no host with a network between cards was available
    dcn_gbps=None,
    dcn_latency_us=None,
)

DEFAULT_SPEC = H100_SPEC


def _dcn_known(spec: ChipSpec) -> bool:
    return spec.dcn_gbps is not None and spec.dcn_latency_us is not None


def local_matvec_us(n: int, p: int, spec: ChipSpec = DEFAULT_SPEC) -> float:
    """HBM-bound time of one shard's (n/P × n) GEMV."""
    return (n / p) * n * spec.itemsize / spec.hbm_gbps / 1e3


def gather_exchange_us(
    n: int, p: int, hosts: int = 1, spec: ChipSpec = DEFAULT_SPEC
) -> Optional[float]:
    """Per-round all_gather of the O(n) vector (gathered form); None when
    the mesh spans hosts and the spec's DCN is not measured."""
    if p == 1:
        return 0.0
    if hosts > 1 and not _dcn_known(spec):
        return None
    wire = (p - 1) / p * n * spec.itemsize / spec.ici_gbps / 1e3
    lat = (p - 1) * spec.ici_latency_us
    if hosts > 1:
        # one chunk boundary per host crossing rides DCN instead of ICI
        dcn_bytes = (hosts - 1) / p * n * spec.itemsize
        wire += dcn_bytes / spec.dcn_gbps / 1e3
        lat += (hosts - 1) * spec.dcn_latency_us
    return wire + lat


def ring_exchange_exposed_us(
    n: int, p: int, hosts: int = 1, spec: ChipSpec = DEFAULT_SPEC
) -> Optional[float]:
    """EXPOSED (non-overlapped) exchange cost of the ring form: each of the
    P−1 rotation steps overlaps an n/P-chunk transfer with that chunk's
    GEMV; only the excess of wire over compute is paid.  None when the mesh
    spans hosts and the spec's DCN is not measured."""
    if p == 1:
        return 0.0
    if hosts > 1 and not _dcn_known(spec):
        return None
    chunk_compute = local_matvec_us(n, p, spec) / p  # one chunk's GEMV
    chunk_wire = (n / p) * spec.itemsize / spec.ici_gbps / 1e3 + spec.ici_latency_us
    exposed = max(0.0, chunk_wire - chunk_compute) * (p - 1)
    if hosts > 1:
        dcn_chunk = (n / p) * spec.itemsize / spec.dcn_gbps / 1e3 + spec.dcn_latency_us
        exposed += max(0.0, dcn_chunk - chunk_compute) * (hosts - 1)
    return exposed


def exchange_2d_us(
    n: int, pr: int, pc: int, hosts: int = 1, spec: ChipSpec = DEFAULT_SPEC
) -> Optional[float]:
    """Per-round exchange of the 2D block-sharded form
    (parallel/sharded.py::solve_sharded_2d): a psum of the n/pr partial
    row-sum vector along the pc-chip cols axis (ring all-reduce:
    2(pc−1)/pc of the payload over the wire) followed by the same
    row-axis all_gather as the 1D gathered form.  The cols axis is laid
    out innermost (intra-host) so the psum rides ICI; only the rows
    gather can cross hosts."""
    gather = gather_exchange_us(n, pr, hosts, spec)
    if gather is None:
        return None
    psum = 0.0
    if pc > 1:
        payload = (n / pr) * spec.itemsize
        psum = (
            2 * (pc - 1) / pc * payload / spec.ici_gbps / 1e3
            + 2 * (pc - 1) * spec.ici_latency_us
        )
    return psum + gather


def round_time_2d_us(
    n: int,
    pr: int,
    pc: int,
    hosts: int = 1,
    spec: ChipSpec = DEFAULT_SPEC,
) -> Optional[float]:
    """Predicted per-round wall time of the 2D block-sharded solve: the
    HBM-bound (n/pr × n/pc) block GEMV plus the psum+gather exchange."""
    exch = exchange_2d_us(n, pr, pc, hosts, spec)
    if exch is None:
        return None
    local = (n / pr) * (n / pc) * spec.itemsize / spec.hbm_gbps / 1e3
    return local + exch


def balanced_factorization(p: int) -> tuple:
    """(pr, pc) with pr·pc = p and pr the largest divisor ≤ √p — the
    squarest mesh shape, which the bench suite and prediction table use."""
    pr = 1
    for cand in range(1, int(p**0.5) + 1):
        if p % cand == 0:
            pr = cand
    return pr, p // pr


def round_time_us(
    n: int,
    p: int,
    hosts: int = 1,
    ring: bool = False,
    spec: ChipSpec = DEFAULT_SPEC,
) -> Optional[float]:
    """Predicted per-round wall time of the sharded matvec-form solve."""
    exch = (
        ring_exchange_exposed_us(n, p, hosts, spec)
        if ring
        else gather_exchange_us(n, p, hosts, spec)
    )
    if exch is None:
        return None
    return local_matvec_us(n, p, spec) + exch


def scaling_efficiency(
    n: int,
    p: int,
    hosts: int = 1,
    ring: bool = False,
    spec: ChipSpec = DEFAULT_SPEC,
) -> Optional[float]:
    """Predicted strong-scaling efficiency vs the 1-chip round time:
    ideal = T(1)/P, efficiency = ideal / T(P)."""
    t1 = round_time_us(n, 1, 1, ring, spec)
    tp = round_time_us(n, p, hosts, ring, spec)
    return None if tp is None else (t1 / p) / tp


def fit_exchange(measured_us, p: int, itemsize: int = 4):
    """Calibrate exchange parameters from MEASURED all_gather times.

    ``measured_us`` maps vector length n → measured per-gather µs on a
    P-shard mesh.  The gathered-form model is linear in n —
    ``exchange(n) = (P−1)·lat + (P−1)/P · itemsize/gbps·1e-3 · n`` —
    so a least-squares line through ≥2 dims recovers the effective link
    bandwidth (slope) and per-step latency (intercept).  Returns
    ``(gbps, latency_us)`` suitable for ``ChipSpec(ici_gbps=,
    ici_latency_us=)`` — this is how the model's nameplate guesses are
    anchored to at least one real measured exchange (VERDICT r1 item 7).
    """
    import numpy as np

    ns = np.array(sorted(measured_us), dtype=np.float64)
    ys = np.array([measured_us[int(n)] for n in ns], dtype=np.float64)
    slope, intercept = np.polyfit(ns, ys, 1)
    if slope <= 0:
        gbps = float("inf")  # latency-dominated regime: slope unresolvable
    else:
        gbps = (p - 1) / p * itemsize / (slope * 1e3)
    latency_us = max(float(intercept), 0.0) / max(p - 1, 1)
    return float(gbps), latency_us


def calibration_rows(measured_us, p: int, spec: ChipSpec = None, base: ChipSpec = V5E_SPEC):
    """Predicted-vs-measured exchange rows + the fitted parameters.

    ``spec`` describes the transport the measurement ran on; when omitted
    (the normal calibration flow) it is built from :func:`fit_exchange` on
    the measurements themselves on ``base`` (whose itemsize it takes) —
    ONE fit feeds both the emitted fit row
    and the predictions, so the two cannot drift apart.  Passing a spec
    skips the fit and reports ITS parameters in the fit row (callers that
    fit once and reuse the spec elsewhere stay provably on that one fit)."""
    if spec is None:
        gbps, lat = fit_exchange(measured_us, p, base.itemsize)
        spec = dataclasses.replace(base, ici_gbps=gbps, ici_latency_us=lat)
    else:
        gbps, lat = spec.ici_gbps, spec.ici_latency_us
    rows = []
    for n in sorted(measured_us):
        pred = gather_exchange_us(n, p, 1, spec)
        meas = measured_us[n]
        rows.append(
            {
                "bench": "model_calibration",
                "dim": n,
                "chips": p,
                "measured_us": meas,
                "predicted_us": pred,
                "ratio": meas / pred if pred > 0 else None,
            }
        )
    rows.append(
        {
            "bench": "model_calibration_fit",
            "chips": p,
            # inf ⇒ the transport is latency-dominated and the bandwidth
            # term is unresolvable from these dims; null keeps the JSON
            # RFC-valid
            "fit_gbps": None if gbps == float("inf") else gbps,
            "fit_latency_us": lat,
        }
    )
    return rows


def sensitivity_table(
    n: int = 32768,
    chip_counts=(16, 64),
    chips_per_host: int = 8,
    gbps_vals=(100.0, 200.0, 400.0, 800.0),
    lat_vals=(0.5, 1.0, 5.0, 25.0),
    spec: ChipSpec = V5E_SPEC,
) -> List[dict]:
    """Efficiency sensitivity to the link parameters of ``spec``, none of
    which was measured across cards: sweeps the link bandwidth and latency
    over ``gbps_vals`` × ``lat_vals`` and reports predicted efficiency for
    both solver forms — showing how much the predictions move if the
    parameters are wrong.  (The defaults are the JAX package's v5e sweep.)"""
    rows = []
    for p in chip_counts:
        hosts = max(1, p // chips_per_host)
        for g in gbps_vals:
            for l in lat_vals:
                swept = dataclasses.replace(spec, ici_gbps=g, ici_latency_us=l)
                for ring in (False, True):
                    rows.append(
                        {
                            "bench": "model_sensitivity",
                            "dim": n,
                            "chips": p,
                            "hosts": hosts,
                            "ici_gbps": g,
                            "ici_latency_us": l,
                            "solver": "matvec_ring" if ring else "matvec_gather",
                            "efficiency": scaling_efficiency(
                                n, p, hosts, ring, swept
                            ),
                        }
                    )
    return rows


def prediction_table(
    dims: List[int] = (8192, 32768, 65536),
    chip_counts: List[int] = (1, 4, 8, 16, 64, 256),
    chips_per_host: int = 8,
    spec: ChipSpec = DEFAULT_SPEC,
) -> List[dict]:
    """Model predictions for the bench CLI (--suite model): per dim and
    card count, the gathered and ring forms and the squarest 2-D mesh;
    ``round_us`` and ``efficiency`` are None where the spec lacks what the
    prediction needs (a mesh across hosts with the DCN not measured)."""
    rows = []
    for n in dims:
        for p in chip_counts:
            if n % p != 0:
                continue
            hosts = max(1, p // chips_per_host)
            for ring in (False, True):
                rows.append(
                    {
                        "bench": "model",
                        "dim": n,
                        "chips": p,
                        "hosts": hosts,
                        "solver": "matvec_ring" if ring else "matvec_gather",
                        "round_us": round_time_us(n, p, hosts, ring, spec),
                        "efficiency": scaling_efficiency(n, p, hosts, ring, spec),
                    }
                )
            pr, pc = balanced_factorization(p)
            if n % pr == 0 and n % pc == 0:
                t1 = round_time_us(n, 1, 1, False, spec)
                t2d = round_time_2d_us(n, pr, pc, hosts, spec)
                rows.append(
                    {
                        "bench": "model",
                        "dim": n,
                        "chips": p,
                        "hosts": hosts,
                        "solver": f"matvec_2d_{pr}x{pc}",
                        "round_us": t2d,
                        "efficiency": None if t2d is None else (t1 / p) / t2d,
                    }
                )
    return rows
