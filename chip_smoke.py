#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two paths on the card — the batch run,
``PipelineBuilder('info_file=…&fe=dwt-8-fused&train_clf=logreg').execute()``,
and the online service, ``…&serve=true&load_clf=logreg&load_name=…`` —
and holds every CUDA kernel of them against its plain PyTorch version.
Phases, one JSON line each (several for phases 3, 4 and 6):

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: compile every kernel from ``eeg_dataanalysispackage_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together;
3. the fused ingest kernel against its plain version (random, DC-heavy,
   overhanging, single-window, dense, odd-count and main-path-shaped
   inputs; max abs deviation <= 2e-6); the serve megakernel against its
   plain version (random and DC-heavy windows, n = 1 and n = capacity,
   capacity 64, 128 and 2,048; max abs margin deviation <= 2e-6 * ||w||_1;
   padded rows exactly 0; a window's margin equal solo and in a batch);
4. the batch path end to end: an 8-recording x 1,200-marker session
   through the builder with logreg (its model saved), svm and the
   ``-fused-pallas`` spelling on the card; the ingest kernel's launch
   count over the logreg run; statistics equal to the port's CPU run (a
   test row may differ only where its margin lies within 1e-4 of the
   threshold on both runs);
5. the serving path end to end: ``serve=true`` with the saved model on
   the card (the ``mega`` rung, the megakernel's launch count over the
   run, every kept epoch completed, none shed, a clean drain, latency
   p50/p99 and mean batch size), statistics equal to the card's batch
   ``load_clf=`` run and to the CPU ``serve=true`` run under the same
   near-threshold rule; a ``fused``-rung service predicting what the
   ``mega`` service predicts; one 64-window batch split into host
   staging, host-to-device copy, kernel call, margin sync and the whole
   ``engine.execute`` (host wall, medians of 25); a 16-thread
   ``predict_window`` probe;
6. timing (CUDA events, median of 25) beside the plain version's time
   and the card's bound: the ingest kernel at 32,768 windows, the
   megakernel at capacity 64 (one serve batch) and at 32,768 windows.

Then the ``kernels`` line, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
``ok`` line. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics as pystats
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 2e-6  # kernel vs plain version: summation orders only
# a margin carries a feature error times at most ||w||_1
MARGIN_TOL_PER_L1 = KERNEL_TOL
MARGIN_BAND = 1e-4  # a differing test row must sit this close to the threshold

# Datasheet peaks (NVIDIA H100/H200 data sheets): memory bytes/s and
# float32 FLOP/s outside the tensor cores, keyed by a substring of the
# card's name; the first match wins.
CARD_PEAKS = (
    ("H100 PCIE", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_peaks(name: str):
    upper = name.upper()
    for key, bw, flops in CARD_PEAKS:
        if key in upper:
            return bw, flops
    raise RuntimeError(f"no datasheet peaks recorded for {name!r}")


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return pystats.median(times)


def needed_samples(starts, n_samples: int, pre: int, skip: int, epoch: int) -> int:
    """Distinct stream samples the windows read per channel: the baseline
    [s, s+pre) and analysis [s+pre+skip, s+pre+skip+epoch) segments, as
    a union clipped to the stream."""
    import numpy as np

    s = np.asarray(starts, dtype=np.int64)
    lo = np.concatenate([s, s + pre + skip])
    hi = np.concatenate([s + pre, s + pre + skip + epoch])
    lo, hi = np.clip(lo, 0, n_samples), np.clip(hi, 0, n_samples)
    order = np.argsort(lo, kind="stable")
    total, reach = 0, 0
    for a, b in zip(lo[order], hi[order]):
        a = max(a, reach)
        if b > a:
            total += int(b - a)
            reach = b
    return total


def phase_kernel_cases(torch, np, ingest_cuda, device_ingest, W, dev):
    """Kernel against its plain version on the card, per input case."""
    res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
    rng = np.random.RandomState(0)

    def stream(S, dc=(0, 0, 0), noise=3000):
        x = rng.randint(-noise, noise, size=(3, S)) + np.asarray(dc)[:, None]
        return torch.from_numpy(np.clip(x, -32768, 32767).astype(np.int16)).to(dev)

    S = 200_000
    main_S = 1_212_416  # a staged 1,200-marker recording (16,384-sample buckets)
    main_starts = np.concatenate([100 + 4500 * np.arange(267), np.full(53, main_S)])
    cases = {
        "random": (stream(S), np.sort(rng.randint(0, S - 787, size=500))),
        "dc_heavy": (stream(S, (30000, -30000, 29500), 1500), 1000 * np.arange(150)),
        "overhang": (stream(S), np.array([10, S - 300, S - 686, S - 1, S])),
        "single": (stream(S), np.array([12345])),
        "dense": (stream(S), 3 + 37 * np.arange(2000)),
        "odd_count": (stream(S), rng.randint(0, S, size=1001)),
        "main_path_shape": (stream(main_S), main_starts),
    }
    worst = 0.0
    for name, (raw, starts_np) in cases.items():
        starts = torch.from_numpy(starts_np.astype(np.int32)).to(dev)
        got = ingest_cuda.ingest_features(raw, res, starts, W)
        torch.cuda.synchronize()
        want = device_ingest.ingest_features_plain(raw, res, starts, W)
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        at_end = starts_np >= raw.shape[1]
        zero_rows = bool((got[torch.from_numpy(at_end).to(dev)] == 0).all())
        emit("kernel_vs_plain", case=name, windows=int(len(starts_np)),
             samples=int(raw.shape[1]), max_abs_err=err, tol=KERNEL_TOL,
             finite=finite, end_rows_zero=zero_rows)
        if not (err <= KERNEL_TOL and finite and zero_rows
                and got.shape == (len(starts_np), 48)):
            raise AssertionError(f"kernel disagrees with its plain version on {name}")
        worst = max(worst, err)
    return worst


def write_session(directory: str, n_files: int = 8, n_markers: int = 1200) -> str:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _synthetic

    lines = []
    for i in range(n_files):
        guessed = 1 + (i * 4) % 9
        _synthetic.write_recording(
            directory, name=f"rec_{i:02d}", n_markers=n_markers,
            guessed=guessed, seed=100 + i, marker_stride=1000,
        )
        lines.append(f"rec_{i:02d}.eeg {guessed}")
    info = os.path.join(directory, "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


def compare_runs(torch, np, gpu, cpu, label: str) -> None:
    """Equal statistics, or differing test rows within MARGIN_BAND of the
    threshold on both runs (printed)."""
    rows = []
    if str(gpu.statistics) != str(cpu.statistics):
        idx_g = torch.as_tensor(gpu.test_index, device=gpu.features.device)
        idx_c = torch.as_tensor(cpu.test_index)
        m_g = gpu.classifier.margin(gpu.features[idx_g]).double().cpu().numpy()
        m_c = cpu.classifier.margin(cpu.features[idx_c]).double().numpy()
        thr = gpu.classifier.margin_threshold
        differ = np.nonzero((m_g > thr) != (m_c > thr))[0]
        for r in differ:
            rows.append({"row": int(gpu.test_index[r]), "margin_cuda": float(m_g[r]),
                         "margin_cpu": float(m_c[r])})
        near = all(abs(x["margin_cuda"] - thr) <= MARGIN_BAND
                   and abs(x["margin_cpu"] - thr) <= MARGIN_BAND for x in rows)
        if not rows or not near:
            raise AssertionError(f"{label}: statistics differ beyond near-threshold rows: {rows}")
    emit("cpu_parity", run=label, statistics_equal=not rows, near_threshold_rows=rows)


def build_kernels(cuda_build, names):
    """Build every named kernel from the checkout's sources, one nvcc
    each, all started together; a stale library is rebuilt."""
    for name in names:
        stale = cuda_build.library_path(name)
        if os.path.exists(stale):
            os.remove(stale)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(cuda_build.build, names))
    seconds = time.perf_counter() - t0
    for name, lib in zip(names, libs):
        ptxas = [ln.strip() for ln in cuda_build.BUILD_LOGS.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", kernel=name, seconds_all=seconds,
             library=os.path.relpath(lib, REPO), ptxas=ptxas)


def mega_batch(torch, np, serve_mega, dev, capacity, n, dc, noise, seed):
    """``n`` windows of int16 noise over ``dc`` staged at capacity
    ``capacity``, with resolutions, the cascade operator and random
    weights, on ``dev``."""
    stride = serve_mega.padded_stride(100, 750)
    rng = np.random.RandomState(seed)
    windows = [
        np.clip(rng.randint(-noise, noise, size=(3, 850)) + np.asarray(dc)[:, None],
                -32768, 32767).astype(np.int16)
        for _ in range(n)
    ]
    stream = serve_mega.stage_mega_stream(windows, 3, 850, stride, capacity)
    weights = torch.from_numpy(rng.randn(48).astype(np.float32)).to(dev)
    res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
    return torch.from_numpy(stream).to(dev), res, weights, stride


def phase_mega_cases(torch, np, serve_mega, serve_mega_cuda, W, dev):
    """The megakernel against its plain version on the card, per input
    case; padded rows exactly 0; one window's margin equal solo and in
    a batch."""
    worst = 0.0
    cases = []
    for capacity in (64, 128, 2048):
        for n in (1, capacity):
            cases.append((f"random_cap{capacity}_n{n}", capacity, n, (0, 0, 0), 3000))
            cases.append((f"dc_heavy_cap{capacity}_n{n}", capacity, n,
                          (30000, -30000, 29500), 1500))
    cases.append(("odd_count_cap128_n77", 128, 77, (15000, -12000, 9000), 3000))
    for seed, (name, capacity, n, dc, noise) in enumerate(cases):
        stream, res, weights, stride = mega_batch(torch, np, serve_mega, dev, capacity,
                                                  n, dc, noise, seed)
        got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride)
        torch.cuda.synchronize()
        want = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, 175, stride)
        err = (got - want).abs().max().item()
        tol = MARGIN_TOL_PER_L1 * weights.abs().sum().item()
        finite = bool(torch.isfinite(got).all())
        pad_zero = bool((got[n:] == 0).all())
        # the last window alone in slot 0 of an otherwise empty batch
        solo = torch.zeros_like(stream)
        solo[:, :stride] = stream[:, (n - 1) * stride:n * stride]
        solo_m = serve_mega_cuda.serve_mega_margins(solo, res, W, weights, 100, 175, stride)
        solo_equal = solo_m[0].item() == got[n - 1].item()
        emit("mega_vs_plain", case=name, capacity=capacity, windows=n, max_abs_err=err,
             tol=tol, finite=finite, padded_rows_zero=pad_zero, solo_equals_batch=solo_equal)
        if not (err <= tol and finite and pad_zero and solo_equal
                and got.shape == (capacity,)):
            raise AssertionError(f"megakernel disagrees with its plain version on {name}")
        worst = max(worst, err)
    return worst


def differing_rows(pred_a, m_a, pred_b, m_b, thr, label):
    """Rows whose predictions differ between two runs; each must lie
    within MARGIN_BAND of the threshold on both (raises otherwise)."""
    rows = []
    for r in range(len(pred_a)):
        if pred_a[r] != pred_b[r]:
            rows.append({"row": r, "margin_a": float(m_a[r]), "margin_b": float(m_b[r])})
    if not all(abs(x["margin_a"] - thr) <= MARGIN_BAND and abs(x["margin_b"] - thr) <= MARGIN_BAND
               for x in rows):
        raise AssertionError(f"{label}: predictions differ beyond near-threshold rows: {rows}")
    return rows


def phase_serve(torch, np, info, model, kept):
    """serve=true end to end on the card, held against the card's batch
    load_clf= run and the CPU serve=true run; returns the megakernel's
    launches over the serve run."""
    from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda, serve_mega, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.serve import InferenceService, engine

    base = f"info_file={info}&fe=dwt-8-fused&load_clf=logreg&load_name={model}"
    batch = PipelineBuilder(base)
    batch_stats = batch.execute()

    # the serving path: counts start at 0 just before the run
    ingest_cuda.LAUNCHES = 0
    serve_mega_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    served_builder = PipelineBuilder(base + "&serve=true")
    served = served_builder.execute()
    wall = time.perf_counter() - t0
    launches = serve_mega_cuda.LAUNCHES
    warmup_ingest_launches = ingest_cuda.LAUNCHES
    block = served_builder.serve_block
    req = block["requests"]
    emit("serve_e2e", rung=block["rung"], serve_mega_launches=launches,
         ingest_launches_warmup=warmup_ingest_launches, kept=kept,
         completed=req["completed"], shed=req["shed"], failed=req["failed"],
         deadline_exceeded=req["deadline_exceeded"], batches=block["batches"],
         mean_batch_size=block["mean_batch_size"], latency_ms=block["latency_ms"],
         drained_cleanly=block["drained_cleanly"], mega_gate=block["mega"]["gate"],
         wall_s=wall, stages_s=served_builder.timers, accuracy=served.calc_accuracy())
    if not (block["rung"] == "mega" and launches >= math.ceil(kept / 64)
            and req["completed"] == kept and req["shed"] == 0
            and block["drained_cleanly"] is True):
        raise AssertionError("serve=true did not serve every epoch through the megakernel")
    cpu_served = PipelineBuilder(base + "&serve=true", device="cpu").execute()

    # per row: the session's windows through mega, fused and CPU services
    odp = OfflineDataProvider([info], device="cpu")
    windows, resolutions = [], []
    balance = BalanceState()
    for _rel, guessed, rec in odp.iter_recordings():
        ws, _ts, res = engine.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed, balance=balance)
        windows.extend(ws)
        resolutions.extend([res] * len(ws))
    runs = {}
    for label, kwargs in (("mega", {}), ("fused", {"engine_rung": "fused"}),
                          ("cpu", {"device": "cpu"})):
        with InferenceService.from_saved("logreg", model, **kwargs) as svc:
            results = svc.predict_all(windows, resolutions)
        runs[label] = (np.array([r.prediction for r in results]),
                       np.array([r.margin for r in results], dtype=np.float64))
    batch_m = batch.classifier.margin(batch.features).double().cpu().numpy()
    batch_p = (batch_m > batch.classifier.margin_threshold).astype(np.float64)
    thr = batch.classifier.margin_threshold
    vs_batch = differing_rows(runs["mega"][0], runs["mega"][1], batch_p, batch_m, thr,
                              "mega service vs batch load_clf=")
    vs_fused = differing_rows(runs["mega"][0], runs["mega"][1], *runs["fused"], thr,
                              "mega service vs fused service")
    vs_cpu = differing_rows(runs["mega"][0], runs["mega"][1], *runs["cpu"], thr,
                            "mega service on the card vs on the CPU")
    stats_equal_batch = str(served) == str(batch_stats)
    stats_equal_cpu = str(served) == str(cpu_served)
    emit("serve_parity", statistics_equal_batch=stats_equal_batch,
         statistics_equal_cpu_serve=stats_equal_cpu,
         max_margin_dev_batch=float(np.abs(runs["mega"][1] - batch_m).max()),
         max_margin_dev_fused=float(np.abs(runs["mega"][1] - runs["fused"][1]).max()),
         max_margin_dev_cpu=float(np.abs(runs["mega"][1] - runs["cpu"][1]).max()),
         near_threshold_rows_batch=vs_batch, near_threshold_rows_fused=vs_fused,
         near_threshold_rows_cpu=vs_cpu)
    if (not stats_equal_batch and not vs_batch) or (not stats_equal_cpu and not vs_cpu):
        raise AssertionError("serve=true statistics differ with no near-threshold row")

    # one full batch through the mega rung, step by step (medians of 25)
    with InferenceService.from_saved("logreg", model) as svc:
        eng = svc.engine
        batch_w, res_np = windows[:64], resolutions[0]
        res_t = torch.from_numpy(res_np).to(eng.device)

        def host_ms(fn, runs=25):
            times = []
            for _ in range(runs):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return pystats.median(times)

        stream = serve_mega.stage_mega_stream(batch_w, 3, 850, eng._mega_stride, eng.capacity)
        staged = torch.from_numpy(stream).to(eng.device)
        margins = eng._mega_program(staged, res_t, eng._weights)
        split = {
            "host_staging_ms": host_ms(lambda: serve_mega.stage_mega_stream(
                batch_w, 3, 850, eng._mega_stride, eng.capacity)),
            "h2d_ms": host_ms(lambda: torch.from_numpy(stream).to(eng.device)),
            "kernel_call_ms": host_ms(lambda: eng._mega_program(staged, res_t, eng._weights)),
            "margin_sync_ms": host_ms(lambda: margins.cpu()),
            "engine_execute_ms": host_ms(lambda: eng.execute(batch_w, res_np)),
        }
    emit("serve_split", batch=64, **split)

    # 16 callers at once, one blocking request each at a time
    n_probe = 480
    rows = [i % len(windows) for i in range(n_probe)]
    with InferenceService.from_saved("logreg", model) as svc:
        with ThreadPoolExecutor(16) as pool:
            probe = list(pool.map(lambda r: svc.predict_window(windows[r], resolutions[r]),
                                  rows))
    pblock = svc.stats_block()
    probe_ok = [r.prediction for r in probe] == list(runs["mega"][0][rows])
    emit("serve_probe_16_threads", requests=n_probe,
         completed=pblock["requests"]["completed"], batches=pblock["batches"],
         mean_batch_size=pblock["mean_batch_size"], latency_ms=pblock["latency_ms"],
         predictions_equal=probe_ok)
    if pblock["requests"]["completed"] != n_probe or not probe_ok:
        raise AssertionError("the 16-thread probe lost requests or changed predictions")
    return launches


def mega_bound(n: int, bandwidth: float, f32_peak: float):
    """Least card time for the megakernel's function on ``n`` windows:
    the 612 needed int16 samples per channel and window read once, one
    float32 margin written per window, operator, weights and
    resolutions read once; against its float32 operations."""
    bytes_moved = 3 * n * (100 + 512) * 2 + n * 4 + 512 * 16 * 4 + 48 * 4 + 3 * 4
    flops = 2 * n * 3 * 512 * 16 + 2 * n * 48
    t_bytes, t_flops = bytes_moved / bandwidth * 1e3, flops / f32_peak * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations"), \
        bytes_moved, flops


def mega_timing(torch, serve_mega, serve_mega_cuda, W, dev, n, bandwidth, f32_peak, smi):
    """Megakernel and plain times on ``n`` full windows."""
    stride = serve_mega.padded_stride(100, 750)
    gen = torch.Generator(device=dev).manual_seed(n)
    stream = torch.randint(-3000, 3000, (3, n * stride), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int16)
    res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
    weights = torch.randn(48, generator=gen, device=dev, dtype=torch.float32)
    args = (stream, res, W, weights, 100, 175, stride)
    got = serve_mega_cuda.serve_mega_margins(*args)
    want = serve_mega.serve_mega_margins_plain(*args)
    err = (got - want).abs().max().item()
    if err > MARGIN_TOL_PER_L1 * weights.abs().sum().item():
        raise AssertionError(f"megakernel disagrees at the timing size {n}: {err}")
    kernel_ms = time_ms(lambda: serve_mega_cuda.serve_mega_margins(*args))
    plain_ms = time_ms(lambda: serve_mega.serve_mega_margins_plain(*args))
    bound_ms, bound_by, bytes_moved, flops = mega_bound(n, bandwidth, f32_peak)
    emit("timing", kernel="serve_mega", windows=n, stride=stride, kernel_ms=kernel_ms,
         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved,
         flops=flops, library_ms=None, max_abs_err=err, nvidia_smi=smi)
    return kernel_ms, plain_ms, bound_ms, bound_by, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from eeg_dataanalysispackage_tpu_torch.ops import (
            cuda_build, device_ingest, dwt, ingest_cuda, serve_mega, serve_mega_cuda,
        )
        from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    bandwidth, f32_peak = card_peaks(kind)
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, peak_bytes_per_s=bandwidth, peak_f32_flops=f32_peak)

    # 2. build every kernel from the checkout's sources
    build_kernels(cuda_build, ["ingest_features", "serve_mega"])
    ingest_cuda.build()
    serve_mega_cuda.build()

    # 3. each kernel against its plain version
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)
    max_err = phase_kernel_cases(torch, np, ingest_cuda, device_ingest, W, dev)
    mega_err = phase_mega_cases(torch, np, serve_mega, serve_mega_cuda, W, dev)

    # 4. the batch path end to end on an 8 x 1,200-marker session
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        info = write_session(work)
        emit("session", recordings=8, markers_each=1200, seconds=time.perf_counter() - t0)
        base = f"info_file={info}&result_path={work}/result.txt"
        model = os.path.join(work, "model_logreg")
        runs = {}
        for label, query, device in (
            ("logreg_cuda", base + "&fe=dwt-8-fused&train_clf=logreg"
             f"&save_clf=true&save_name={model}", None),
            ("svm_cuda", base + "&fe=dwt-8-fused&train_clf=svm", None),
            ("logreg_cuda_pallas_spelling", base + "&fe=dwt-8-fused-pallas&train_clf=logreg", None),
            ("logreg_cpu", base + "&fe=dwt-8-fused&train_clf=logreg", "cpu"),
            ("svm_cpu", base + "&fe=dwt-8-fused&train_clf=svm", "cpu"),
        ):
            ingest_cuda.LAUNCHES = 0  # counts start at 0 just before each run
            t0 = time.perf_counter()
            builder = PipelineBuilder(query, device=device)
            stats = builder.execute()
            wall = time.perf_counter() - t0
            launches = ingest_cuda.LAUNCHES
            runs[label] = (builder, launches)
            emit("e2e", run=label, device=str(builder.features.device), launches=launches,
                 rows=int(len(builder.targets)), accuracy=stats.calc_accuracy(),
                 wall_s=wall, stages_s=builder.timers)
            if device is None:
                if builder.features.device.type != "cuda" or launches < 8:
                    raise AssertionError(f"{label} did not run the kernel on the card")
            elif launches != 0:
                raise AssertionError(f"{label} launched the kernel on the CPU path")
        gpu, cpu = runs["logreg_cuda"][0], runs["logreg_cpu"][0]
        feat_err = (gpu.features.cpu() - cpu.features).abs().max().item()
        emit("features_cuda_vs_cpu", max_abs_err=feat_err, tol=KERNEL_TOL)
        if feat_err > KERNEL_TOL:
            raise AssertionError("card features disagree with the CPU run")
        compare_runs(torch, np, gpu, cpu, "logreg")
        compare_runs(torch, np, runs["svm_cuda"][0], runs["svm_cpu"][0], "svm")
        if str(runs["logreg_cuda_pallas_spelling"][0].statistics) != str(gpu.statistics):
            raise AssertionError("-fused-pallas spelling changed the statistics")
        main_launches = runs["logreg_cuda"][1]

        # 5. the serving path end to end with the card's saved model
        serve_launches = phase_serve(torch, np, info, model, kept=int(len(gpu.targets)))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 6. timing: the ingest kernel at 32,768 windows, 1,000-sample stride
    n, stride = 32_768, 1000
    S = n * stride + 1000
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(-3000, 3000, (3, S), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.int16)
    res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
    starts = (torch.arange(n, device=dev, dtype=torch.int32) * stride).contiguous()
    got = ingest_cuda.ingest_features(raw, res, starts, W)
    want = device_ingest.ingest_features_plain(raw, res, starts, W)
    timing_err = (got - want).abs().max().item()
    if timing_err > KERNEL_TOL:
        raise AssertionError(f"kernel disagrees at the timing size: {timing_err}")
    del got, want
    kernel_ms = time_ms(lambda: ingest_cuda.ingest_features(raw, res, starts, W))
    plain_ms = time_ms(lambda: device_ingest.ingest_features_plain(raw, res, starts, W))
    samples = needed_samples(starts.cpu().numpy(), S, 100, 175, 512)
    bytes_moved = 3 * samples * 2 + n * 48 * 4 + n * 4 + W.numel() * 4 + 3 * 4
    flops = 2 * n * 3 * 512 * 16
    t_bytes, t_flops = bytes_moved / bandwidth * 1e3, flops / f32_peak * 1e3
    bound_ms = max(t_bytes, t_flops)
    bound_by = "bytes" if t_bytes >= t_flops else "operations"
    emit("timing", kernel="ingest_features", windows=n, stride=stride,
         stream_bytes=int(raw.numel() * 2), kernel_ms=kernel_ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved, flops=flops,
         library_ms=None, max_abs_err=timing_err, nvidia_smi=smi)
    del raw, starts
    # the megakernel at one serve batch (the serving path's shape), then
    # at 32,768 windows
    mega_64 = mega_timing(torch, serve_mega, serve_mega_cuda, W, dev, 64,
                          bandwidth, f32_peak, smi)
    mega_big = mega_timing(torch, serve_mega, serve_mega_cuda, W, dev, 32_768,
                           bandwidth, f32_peak, smi)

    # 7. the kernels line, then the card line, then the result
    print(json.dumps({"kernels": [{
        "name": "ingest_features",
        "route": "cuda",
        "source": "eeg_dataanalysispackage_tpu_torch/csrc/ingest_features.cu",
        "replaces": "eeg_dataanalysispackage_tpu/ops/ingest_pallas.py:314",
        "launches": main_launches,
        "max_abs_err": max(max_err, timing_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "serve_mega",
        "route": "cuda",
        "source": "eeg_dataanalysispackage_tpu_torch/csrc/serve_mega.cu",
        "replaces": "eeg_dataanalysispackage_tpu/ops/serve_mega.py:259",
        "launches": serve_launches,
        "max_abs_err": max(mega_err, mega_64[4], mega_big[4]),
        "ms": mega_64[0],
        "plain_ms": mega_64[1],
        "bound_ms": mega_64[2],
        "bound_by": mega_64[3],
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
