#!/usr/bin/env python3
"""Time many tile plans of the fused kernels' generic engine on one card,
and fit the plan's cost models to those times.

    python3 chip_plans.py > plans.jsonl        # on the card (~6 min)
    python3 chip_plans.py --fit plans.jsonl    # anywhere: refit the models

The first form builds this checkout's kernels and, at each generic case of
``chip_compare.py`` (``chip_smoke.GENERIC_SIZES`` on 4,096 windows of 3
channels, ``GENERIC_PATH_SIZE`` on a serve batch of 64,
``GENERIC_WIDE`` on 256 windows of 76 channels) and on int16 and float32
samples, launches K1-any and K5-any at f32 with each of a set of plans of
both designs (``ops/generic_plan``: the ring design's register tiles at 1
to 64 windows a tile, the phase-by-phase design's own plan and its
shapes at 1 to 16 windows), then K5-any at 16,384 and 32,768 windows of
each GENERIC_SIZES size with the ring design's tiles at 16 to 125 windows
(the baselines staged or not) beside the phase-by-phase plan. One JSON
line a plan: the case, the sample width, the plan's fields, its modelled
clocks, whether the plan search picks it, and the kernels' device times
(``chip_smoke.profiled_device_ms``). Needs one card; imports nothing of
JAX.

The second form reads those lines and fits the constants of
``generic_plan.ring_launch_cost`` and ``phase_launch_cost`` (and the
scale of clocks to milliseconds) by least squares on the logarithm of
the device times, weighting each design's best plan of a case most, and
prints the constants and, per case, the measured best plan beside the one
the fitted models pick.
"""

from __future__ import annotations

import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
#: the constants the fit sets, and their bounds
FITTED = {
    "TILE_FIXED": (2000, 60000), "COPY_LATENCY": (200, 4000), "HANDOFF": (20, 3000),
    "COPY_ISSUE": (20, 1000), "MEANS_ROUND": (500, 10000), "RING_ISSUE": (0.8, 4),
    "RING_STALL": (1, 200), "MEANS_DEVICE": (300, 60000), "CENTRE_ROWS": (50, 2000),
    "PHASE_TILE_FIXED": (2000, 60000), "PHASE_PIECE_FIXED": (200, 20000),
    "PHASE_CENTRE_STEP": (10, 1000), "PHASE_CENTRE_STEP_F32": (10, 1000),
    "PHASE_CHUNK_FIXED": (100, 5000), "PHASE_NORM": (100, 10000), "PHASE_ISSUE": (0.5, 5),
    "PHASE_STAGE_ISSUE": (5, 2000), "CLOCKS_PER_MS": (1.5e6, 2.0e6),
}
#: an H100's multiprocessors and per-block shared-memory opt-in limit, for
#: the fit
SMS, OPTIN = 132, 232_448


def candidates(generic_plan, C, e, K, n, sb, optin):
    """Plans of both designs for one launch: the ring design's register
    tiles at 1 to 64 windows a tile (the most slots that fit), the
    phase-by-phase plan and its shapes at 1 to 16 windows a tile."""
    g = generic_plan
    out = []
    base = 4 * g.segment_chunks(100, sb)
    for rr, qq, most in g.RING_TILES:
        tq = g._ring_tq(K, qq, most)
        cap = rr * (g.CONSUMER_THREADS // tq)
        for m in (1, 2, 4, 8, 12, 16, 24, 32, 48, 64):
            if m > n:
                continue
            for slots in (4, 3, 2):
                p = g._ring_plan(m, min(m * C, cap), rr, qq, tq, slots, base, C, K)
                if p.smem <= optin:
                    out.append(p)
                    break
    phase = g.phase_tile_plan(C, e, K, n, SMS, optin, 100, sb)
    out.append(phase)
    for m in (1, 2, 4, 8, 16):
        if m <= n:
            qq = 1 if m * C * K <= g.ONE_COLUMN_OUTPUTS else 4
            p = g._shape(m, C, e, K, 100, sb, g._natural_tq_log2(K, qq), qq=qq)
            if p.smem <= optin and p != phase:
                out.append(p)
    return out


def many_rows(generic_plan, C, e, K, n, sb, optin):
    """At many windows: both designs' plans, and the ring design's 8 x 4
    and 4 x 4 tiles at 16 to 125 windows a tile, the baselines staged
    where they fit, else not."""
    g = generic_plan
    plans = [p for p, _clocks in g.design_plans(C, e, K, n, SMS, optin, 100, sb)]
    base = 4 * g.segment_chunks(100, sb)
    for rr, qq, most in g.RING_TILES[:2]:
        tq = g._ring_tq(K, qq, most)
        cap = rr * (g.CONSUMER_THREADS // tq)
        for m in (16, 32, 63, 83, 125):
            for base_floats in (base, 0):
                fits = [p for p in (g._ring_plan(m, min(m * C, cap), rr, qq, tq, slots,
                                                 base_floats, C, K) for slots in (4, 3, 2))
                        if p.smem <= optin]
                if fits:
                    if fits[0] not in plans:
                        plans.append(fits[0])
                    break
    return plans


def time_plans() -> int:
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from eeg_dataanalysispackage_tpu_torch.ops import (
        dwt, generic_plan, ingest_cuda, serve_mega, serve_mega_cuda,
    )

    if not torch.cuda.is_available():
        print("chip_plans: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    ingest_cuda.build()
    serve_mega_cuda.build()
    limits = ingest_cuda.device_limits(dev)
    smi = cs.nvidia_smi_line()
    plan_of = generic_plan.generic_tile_plan
    stride = serve_mega.padded_stride(100, 750)

    def timed(fn, symbol, runs):
        return cs.profiled_device_ms(fn, symbol, runs=runs)

    def emit(case, sb, plan, chosen, **times):
        C, e, K, n = case
        print(json.dumps({"case": list(case), "sample_bytes": sb, "plan": list(plan.fields()),
                          "clocks": generic_plan.launch_clocks(n, plan, C, e, K, *limits, 100,
                                                               sb),
                          "chosen": plan == chosen, **times, "nvidia_smi": smi}), flush=True)

    cases = ([(size, 4096, 3) for size in cs.GENERIC_SIZES] + [(cs.GENERIC_PATH_SIZE, 64, 3)]
             + [(cs.GENERIC_WIDE, 256, 76)])
    cases += [(size, n, 3) for size in cs.GENERIC_SIZES for n in (16384, 32768)]
    try:
        for (e, K, skip), n, C in cases:
            W = dwt.kernel_operator(8, e, K, dev)
            res = torch.full((C,), 0.1, device=dev)
            gen = torch.Generator(device=dev).manual_seed(n + e + K)
            stream16 = torch.randint(-3000, 3000, (C, n * stride), generator=gen, device=dev,
                                     dtype=torch.int32).to(torch.int16)
            weights = torch.randn(C * K, generator=gen, device=dev)
            big = starts = None
            if n <= 4096:
                big = torch.randint(-3000, 3000, (C, n * 1000 + 1000), generator=gen, device=dev,
                                    dtype=torch.int32)
                starts = torch.arange(n, device=dev, dtype=torch.int32) * 1000
            for sb in (2, 4):
                stream = stream16 if sb == 2 else (stream16.float() * 0.1).contiguous()
                rs = res if sb == 2 else torch.ones(C, device=dev)
                chosen = plan_of(C, e, K, n, *limits, 100, sb)
                if big is not None:
                    raw = big.to(torch.int16) if sb == 2 else (big.float() * 0.1).contiguous()
                    plans = candidates(generic_plan, C, e, K, n, sb, limits[1])
                else:
                    raw = None
                    plans = many_rows(generic_plan, C, e, K, n, sb, limits[1])
                for plan in plans:
                    generic_plan.generic_tile_plan = lambda *a, plan=plan, **k: plan
                    times = {"k5_ms": timed(
                        lambda: serve_mega_cuda.serve_mega_margins(
                            stream, rs, W, weights, 100, skip, stride, "f32", e, K),
                        "serve_mega_any_kernel", 20 if raw is not None else 10)}
                    if raw is not None:
                        times["k1_ms"] = timed(
                            lambda: ingest_cuda.ingest_features(raw, rs, starts, W, 100, skip,
                                                                "f32", e, K),
                            "ingest_features_any_kernel", 20)
                    generic_plan.generic_tile_plan = plan_of
                    emit((C, e, K, n), sb, plan, chosen, **times)
                del stream, raw
    finally:
        generic_plan.generic_tile_plan = plan_of
    return 0


def fit(path: str) -> int:
    import numpy as np
    from scipy.optimize import minimize

    sys.path.insert(0, HERE)
    from eeg_dataanalysispackage_tpu_torch.ops import generic_plan as g

    records = []
    for line in open(path):
        r = json.loads(line)
        if "plan" not in r:  # a profiler_retake line
            continue
        C, e, K, n = r["case"]
        f = r["plan"]
        plan = (g.TilePlan(*f, g.plan_smem_bytes(f, C, e, K)) if f[0] == g.PHASE_DESIGN
                else g.RingTilePlan(*f, g.ring_plan_smem_bytes(f, C, K)))
        for kernel in ("k1_ms", "k5_ms"):
            if r.get(kernel):
                records.append(((C, e, K, n, r["sample_bytes"], kernel), plan, r[kernel]))
    best, best_of_design = {}, {}
    for key, plan, ms in records:
        best[key] = min(best.get(key, math.inf), ms)
        dk = key + (plan.design,)
        best_of_design[dk] = min(best_of_design.get(dk, math.inf), ms)
    weights = [(6.0 if ms == best_of_design[key + (plan.design,)] else 1.0)
               if ms <= 1.6 * best[key] else 0.15 for key, plan, ms in records]
    names = list(FITTED)
    scale = {"CLOCKS_PER_MS": 1.85e6}

    def predicted(key, plan):
        C, e, K, n, sb, _kernel = key
        return (g.launch_clocks(n, plan, C, e, K, SMS, OPTIN, 100, sb)
                / scale["CLOCKS_PER_MS"])

    def set_constants(logs):
        for name, value in zip(names, np.exp(logs)):
            if name == "CLOCKS_PER_MS":
                scale[name] = value
            else:
                setattr(g, name, value)

    def loss(logs):
        set_constants(logs)
        return sum(w * (math.log(predicted(key, plan)) - math.log(ms)) ** 2
                   for w, (key, plan, ms) in zip(weights, records)) / sum(weights)

    lo = np.log([FITTED[n][0] for n in names])
    hi = np.log([FITTED[n][1] for n in names])
    start = np.clip(np.log([scale["CLOCKS_PER_MS"] if n == "CLOCKS_PER_MS" else getattr(g, n)
                            for n in names]), lo, hi)
    result = minimize(loss, start, method="Powell", bounds=list(zip(lo, hi)),
                      options={"maxiter": 20000, "xtol": 1e-3, "ftol": 1e-8})
    result = minimize(loss, result.x, method="Powell", bounds=list(zip(lo, hi)),
                      options={"maxiter": 20000, "xtol": 1e-4, "ftol": 1e-9})
    set_constants(result.x)
    print(json.dumps({"records": len(records), "loss": result.fun,
                      "constants": {n: float(v) for n, v in zip(names, np.exp(result.x))}}))
    for key in sorted(best):
        these = [(plan, ms) for k, plan, ms in records if k == key]
        measured = min(these, key=lambda t: t[1])
        picked = min(these, key=lambda t: predicted(key, t[0]))
        print(json.dumps({"case": list(key), "best": list(measured[0].fields()),
                          "best_ms": measured[1], "picked": list(picked[0].fields()),
                          "picked_ms": picked[1], "picked_model_ms": predicted(key, picked[0])}))
    return 0


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--fit":
        return fit(argv[2])
    if len(argv) != 1:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    return time_plans()


if __name__ == "__main__":
    sys.exit(main(sys.argv))
