#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths on the card — the fused batch run,
``PipelineBuilder('info_file=…&fe=dwt-8-fused&train_clf=logreg').execute()``
at f32 and at ``precision=bf16|int8|int4``, the host ``fe=`` batch run
(``fe=dwt-8-pallas``, ``dwt-8``, ``dwt-8-tpu``), and the online service,
``…&serve=true&load_clf=logreg&load_name=…`` at f32 and at each rung —
and holds every CUDA kernel of them against its plain PyTorch version.
Phases, one JSON line each (several for phases 2 to 6):

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: compile every kernel from ``eeg_dataanalysispackage_tpu_torch/csrc``
   (three sources, every precision instantiation in them), one ``nvcc``
   per source, all started together, with ``ptxas`` registers and spills;
3. each kernel against its plain version (max abs deviation <= 2e-6):
   the fused ingest kernel on int16 streams (random, DC-heavy,
   overhanging, single-window, dense, odd-count and main-path-shaped
   inputs) and on float32 streams (random, DC-heavy, overhanging); on
   every int16 case also its bf16 instantiation (K2-bf16: within 2e-6 of
   its plain version, within BF16_GATE_TOL of the f32 rows) and its
   int8/int4 instantiations (the quantize epilogue equal bit for bit to
   the plain quantizer on the f32 kernel's rows; against the plain chain
   within 2e-6 except counted boundary flips of one step); the serve
   megakernel (random and DC-heavy windows, n = 1 and n = capacity,
   capacity 64, 128 and 2,048; margins within 2e-6 * ||w||_1; padded
   rows exactly 0; a window's margin equal solo and in a batch), and on
   every case its int8/int4 instantiations (within 2e-6 * ||w||_1 of the
   quantized ingest rows dotted with w, within the rung's tolerance of
   the plain version with the row flips counted, padded rows 0, solo
   equal to batch); the epoch-features kernel (B = 1, 5, 37, 128 and
   32,768, DC-heavy epochs, an all-zero epoch giving an exactly zero row,
   5-channel input reduced to 3, a window that does not fit raising);
4. the batch paths end to end on an 8-recording x 1,200-marker session:
   ``fe=dwt-8-fused`` with logreg (its model saved), svm and the
   ``-fused-pallas`` spelling; ``fe=dwt-8-fused&precision=bf16|int8|int4``
   with logreg (the rung used as requested, its gate record, the gate's
   f32 and rung launches plus one rung launch per recording, features
   against the CPU run's within 2e-6 except counted boundary flips), and
   an int4 run forced to trip its gate (``EEG_TPU_INT4_GATE_TOL=1e-9``
   for that run only: f32 used, statistics equal to the f32 run);
   ``fe=dwt-8-pallas`` with logreg and svm, ``fe=dwt-8`` and
   ``fe=dwt-8-tpu`` with logreg; then a 3-recording IEEE_FLOAT_32
   session through ``fe=dwt-8-fused`` and ``fe=dwt-8-pallas``. Every run
   prints the launches of each kernel, counted from 0 just before it
   (the ingest kernel once per recording, the epoch-features kernel
   twice per ``-pallas`` train run), and its statistics equal the port's
   CPU run (a test row may differ only where its margin lies within 1e-4
   of the threshold on both runs). The features each kernel made in a
   run are held at 2e-6 against the CPU run's: the fused runs' rows, and
   the ``-pallas`` logreg runs' own train and test epochs through the
   run's extractor, also against the plain version on the same float32
   tensor;
5. the serving path end to end: ``serve=true`` with the saved model on
   the card (the ``mega`` rung, the megakernel's launch count over the
   run, every kept epoch completed, none shed, a clean drain, latency
   p50/p99 and mean batch size), statistics equal to the card's batch
   ``load_clf=`` run and to the CPU ``serve=true`` run under the same
   near-threshold rule; a ``fused``-rung service predicting what the
   ``mega`` service predicts; one 64-window batch split into host
   staging, host-to-device copy, kernel call, margin sync and the whole
   ``engine.execute`` (host wall, medians of 25); a 16-thread
   ``predict_window`` probe; then ``serve=true&precision=int8|int4`` on
   the ``mega`` rung (the int8/int4 megakernel's launches) and
   ``precision=bf16`` on the ``fused`` rung (K2-bf16's launches), each
   with its statistics equal to the card's batch ``load_clf=`` run at
   the same precision;
6. timing (CUDA events around one wrapper call, median of 25; and the
   kernel's own device time from ``torch.profiler``, mean of 10) beside
   the plain version's time and the card's bound: the ingest kernel at
   32,768 windows on an int16 and on a float32 stream and at the bf16,
   int8 and int4 rungs, the megakernel (f32, int8, int4) at capacity 64
   (one serve batch) and at 32,768 windows, the epoch-features kernel at
   32,768 epochs.

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


def profiled_device_ms(fn, kernel: str, runs: int = 10):
    """Mean device time (ms) of the CUDA kernel whose name contains
    ``kernel`` over ``runs`` calls of ``fn``, from ``torch.profiler``:
    the kernel alone, without the wrapper's host work that a CUDA-event
    pair around one call also counts. None when the profiler reports no
    device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key and ev.count and ev.device_time_total > 0:
            return ev.device_time_total / ev.count / 1e3
    return None


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


def quantizers():
    """The port's plain quantizers by rung, on CPU tensors."""
    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest, quant

    return {"int8": decode_ingest.int8_feature_path, "int4": quant.int4_feature_path}


def flip_check(np, got, want, f32_rows, precision, label):
    """Quantized rows against other quantized rows of the same windows:
    equal within KERNEL_TOL except boundary flips, each exactly one
    quantization step of its group (within KERNEL_TOL). Returns (flips,
    max deviation of the other elements)."""
    import torch

    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest

    got, want = np.asarray(got), np.asarray(want)
    qmax = {"int8": 127.0, "int4": 7.0}[precision]
    scales = decode_ingest.quantize_levels(torch.as_tensor(np.asarray(f32_rows)), 16,
                                           qmax)[1].numpy()
    group_of = [g for g, (lo, hi) in enumerate(decode_ingest.subband_group_bounds(16))
                for _ in range(lo, hi)]
    diff = np.abs(got - want)
    flips = np.argwhere(diff > KERNEL_TOL)
    for r, i in flips:
        step = scales[group_of[i % 16], r, i // 16]
        if abs(diff[r, i] - step) > KERNEL_TOL:
            raise AssertionError(f"{label}: row {r} col {i} differs by {diff[r, i]}, "
                                 f"not one step {step}")
    rest = np.where(diff > KERNEL_TOL, 0.0, diff)
    return int(len(flips)), float(rest.max()) if rest.size else 0.0


def check_rungs(torch, np, ingest_cuda, device_ingest, raw, res, starts, W, f32_rows, name,
                worst):
    """The bf16, int8 and int4 instantiations on one case: bf16 within
    KERNEL_TOL of its plain version and within the bf16 gate of the f32
    rung; int8/int4 equal bit for bit to the plain quantizer applied to
    the f32 kernel's rows, and against the plain chain within KERNEL_TOL
    except counted boundary flips; windows at the end give zero rows."""
    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest

    at_end = starts >= raw.shape[1]
    fields = {}
    bf16 = ingest_cuda.ingest_features(raw, res, starts, W, precision="bf16")
    torch.cuda.synchronize()
    bf16_plain = device_ingest.ingest_features_plain(raw, res, starts, W, precision="bf16")
    err = (bf16 - bf16_plain).abs().max().item()
    vs_f32 = (bf16 - f32_rows).abs().max().item()
    ok = (err <= KERNEL_TOL and vs_f32 <= decode_ingest.BF16_GATE_TOL
          and bool(torch.isfinite(bf16).all()) and bool((bf16[at_end] == 0).all()))
    fields["bf16"] = {"max_abs_err": err, "max_dev_vs_f32": vs_f32}
    worst["bf16"] = max(worst.get("bf16", 0.0), err)
    f32_cpu = f32_rows.cpu()
    for precision, quantize in quantizers().items():
        q = ingest_cuda.ingest_features(raw, res, starts, W, precision=precision)
        torch.cuda.synchronize()
        bit_equal = q.cpu().numpy().tobytes() == quantize(f32_cpu, 16).numpy().tobytes()
        plain = device_ingest.ingest_features_plain(raw, res, starts, W, precision=precision)
        flips, err = flip_check(np, q.cpu(), plain.cpu(), f32_cpu, precision, name)
        ok = ok and bit_equal and bool((q[at_end] == 0).all())
        fields[precision] = {"epilogue_bit_equal": bit_equal, "flips_vs_plain": flips,
                             "max_abs_err": err}
        worst[precision] = max(worst.get(precision, 0.0), err)
    emit("rungs_vs_plain", case=name, windows=int(starts.shape[0]), tol=KERNEL_TOL,
         bf16_gate=decode_ingest.BF16_GATE_TOL, **fields)
    if not ok:
        raise AssertionError(f"a precision instantiation disagrees on {name}: {fields}")


def phase_kernel_cases(torch, np, ingest_cuda, device_ingest, W, dev):
    """Kernel against its plain version on the card, per input case, at
    every precision= instantiation. Returns the worst deviation per
    rung ({"f32": …, "bf16": …, "int8": …, "int4": …})."""
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
    worst = {"f32": 0.0}
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
        worst["f32"] = max(worst["f32"], err)
        check_rungs(torch, np, ingest_cuda, device_ingest, raw, res, starts, W, got, name,
                    worst)
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


def compare_runs(np, gpu, cpu, label: str) -> None:
    """Equal statistics, or differing test rows within MARGIN_BAND of the
    threshold on both runs (printed)."""
    rows = []
    if str(gpu.statistics) != str(cpu.statistics):
        m_g, m_c = margins_on_test_rows(gpu), margins_on_test_rows(cpu)
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


def check_mega_rungs(torch, np, serve_mega, serve_mega_cuda, stream, res, W, weights, stride,
                     n, name, worst):
    """The int8 and int4 megakernels on one case: margins within
    MARGIN_TOL_PER_L1 * ||w||_1 of the quantized ingest kernel's rows of
    the same windows dotted with w; within the rung's tolerance of the
    plain version, with the boundary flips between the kernel's and the
    plain version's rows counted; padded rows 0; the last window's
    margin the same solo and in the batch."""
    from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest, device_ingest, ingest_cuda

    capacity = stream.shape[1] // stride
    starts = (torch.arange(capacity, dtype=torch.int32, device=stream.device) * stride)
    f32_rows = ingest_cuda.ingest_features(stream, res, starts, W).cpu()
    fields, ok = {}, True
    for precision in ("int8", "int4"):
        got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride,
                                                 precision)
        torch.cuda.synchronize()
        rows = ingest_cuda.ingest_features(stream, res, starts, W, 100, 175, precision)
        err = (got - rows @ weights).abs().max().item()
        plain = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, 175,
                                                    stride, precision)
        plain_rows = device_ingest.ingest_features_plain(stream, res, starts, W, 100, 175,
                                                         precision)
        flips, _ = flip_check(np, rows.cpu(), plain_rows.cpu(), f32_rows, precision, name)
        dev_plain = (got - plain).abs().max().item()
        tol = MARGIN_TOL_PER_L1 * weights.abs().sum().item()
        solo = torch.zeros_like(stream)
        solo[:, :stride] = stream[:, (n - 1) * stride:n * stride]
        solo_m = serve_mega_cuda.serve_mega_margins(solo, res, W, weights, 100, 175, stride,
                                                    precision)
        solo_equal = solo_m[0].item() == got[n - 1].item()
        pad_zero = bool((got[n:] == 0).all())
        gate = decode_ingest.precision_gate_tolerance(precision)
        ok = ok and err <= tol and dev_plain <= gate and solo_equal and pad_zero
        fields[precision] = {"max_abs_err": err, "tol": tol, "max_dev_vs_plain": dev_plain,
                             "rung_tol": gate, "row_flips_vs_plain": flips,
                             "padded_rows_zero": pad_zero, "solo_equals_batch": solo_equal}
        worst[precision] = max(worst.get(precision, 0.0), err)
    emit("mega_rungs_vs_ingest", case=name, capacity=capacity, windows=n, **fields)
    if not ok:
        raise AssertionError(f"a quantized megakernel disagrees on {name}: {fields}")


def phase_mega_cases(torch, np, serve_mega, serve_mega_cuda, W, dev):
    """The megakernel against its plain version on the card, per input
    case; padded rows exactly 0; one window's margin equal solo and in
    a batch; the int8 and int4 instantiations on every case
    (:func:`check_mega_rungs`). Returns the worst deviation per rung."""
    worst = {"f32": 0.0}
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
        worst["f32"] = max(worst["f32"], err)
        check_mega_rungs(torch, np, serve_mega, serve_mega_cuda, stream, res, W, weights,
                         stride, n, name, worst)
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
    return launches, windows, resolutions


def phase_serve_precisions(np, info, model, kept, windows, resolutions):
    """serve=true&precision=int8|int4|bf16 on the card: int8 and int4 on
    the mega rung through their megakernel instantiations, bf16 on the
    fused rung through K2-bf16; every kept epoch completed; statistics
    equal to the card's batch load_clf= run at the same precision (a row
    may differ only within MARGIN_BAND of the threshold on both).
    Returns {precision: launches of the serving kernel}."""
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda, serve_mega_cuda
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
    from eeg_dataanalysispackage_tpu_torch.serve import InferenceService

    counters = {f"ingest_features_{p}": (ingest_cuda, f"LAUNCHES_{p.upper()}")
                for p in ("bf16", "int8", "int4")}
    counters.update({"ingest_features": (ingest_cuda, "LAUNCHES"),
                     "serve_mega": (serve_mega_cuda, "LAUNCHES"),
                     "serve_mega_int8": (serve_mega_cuda, "LAUNCHES_INT8"),
                     "serve_mega_int4": (serve_mega_cuda, "LAUNCHES_INT4")})
    served_launches = {}
    for precision in ("int8", "int4", "bf16"):
        base = (f"info_file={info}&fe=dwt-8-fused&load_clf=logreg&load_name={model}"
                f"&precision={precision}")
        batch = PipelineBuilder(base)
        batch_stats = batch.execute()
        for module, attr in counters.values():
            setattr(module, attr, 0)
        served_builder = PipelineBuilder(base + "&serve=true")
        served = served_builder.execute()
        counts = {k: getattr(m, a) for k, (m, a) in counters.items()}
        block = served_builder.serve_block
        req = block["requests"]
        kernel = "ingest_features_bf16" if precision == "bf16" else f"serve_mega_{precision}"
        rung = "fused" if precision == "bf16" else "mega"
        rows = []
        if str(served) != str(batch_stats):
            with InferenceService.from_saved("logreg", model, precision=precision) as svc:
                results = svc.predict_all(windows, resolutions)
            thr = batch.classifier.margin_threshold
            batch_m = batch.classifier.margin(batch.features).double().cpu().numpy()
            rows = differing_rows(np.array([r.prediction for r in results]),
                                  np.array([r.margin for r in results], dtype=np.float64),
                                  (batch_m > thr).astype(np.float64), batch_m, thr,
                                  f"serve precision={precision} vs batch")
            if not rows:
                raise AssertionError(f"serve precision={precision}: statistics differ with "
                                     "no near-threshold row")
        emit("serve_precision", precision=precision, rung=block["rung"],
             precision_record=block["precision"], mega=block["mega"], launches=counts,
             stages_s=served_builder.timers, mean_batch_size=block["mean_batch_size"],
             completed=req["completed"], shed=req["shed"], batches=block["batches"],
             latency_ms=block["latency_ms"], statistics_equal_batch=not rows,
             near_threshold_rows_batch=rows, drained_cleanly=block["drained_cleanly"])
        mega_ok = (block["mega"] is None if precision == "bf16"
                   else block["mega"]["precision"] == precision and block["mega"]["gate"]["ok"])
        if not (block["rung"] == rung and mega_ok
                and block["precision"]["used"] == precision
                and counts[kernel] >= math.ceil(kept / 64) and req["completed"] == kept
                and req["shed"] == 0 and block["drained_cleanly"] is True):
            raise AssertionError(f"serve precision={precision} did not serve through {kernel}")
        served_launches[precision] = counts[kernel]
    return served_launches


def phase_f32_stream_cases(torch, np, ingest_cuda, device_ingest, W, dev):
    """The fused ingest kernel's float32-sample instantiation against its
    plain version: random and DC-heavy float32 streams (unit
    resolutions, as a non-INT_16 recording is staged), with windows
    overhanging the end. The baseline mean is not exact in float64 for
    float samples, so the tolerance stays KERNEL_TOL, not bit equality."""
    rng = np.random.RandomState(7)
    S = 200_000
    res = torch.ones(3, dtype=torch.float32, device=dev)
    cases = {
        "f32_random": ((0.0, 0.0, 0.0), 300.0, np.sort(rng.randint(0, S - 787, size=500))),
        "f32_dc_heavy": ((3000.0, -3000.0, 2950.5), 150.0, 1000 * np.arange(150)),
        "f32_overhang": ((0.0, 0.0, 0.0), 300.0, np.array([10, S - 300, S - 686, S - 1, S])),
    }
    worst = 0.0
    for name, (dc, noise, starts_np) in cases.items():
        x = rng.randn(3, S) * noise + np.asarray(dc)[:, None]
        raw = torch.from_numpy(x.astype(np.float32)).to(dev)
        starts = torch.from_numpy(starts_np.astype(np.int32)).to(dev)
        got = ingest_cuda.ingest_features(raw, res, starts, W)
        torch.cuda.synchronize()
        want = device_ingest.ingest_features_plain(raw, res, starts, W)
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        end_zero = bool((got[torch.from_numpy(starts_np >= S).to(dev)] == 0).all())
        emit("kernel_vs_plain", kernel="ingest_features_f32", case=name,
             windows=int(len(starts_np)), samples=S, max_abs_err=err, tol=KERNEL_TOL,
             finite=finite, end_rows_zero=end_zero)
        if not (err <= KERNEL_TOL and finite and end_zero and got.shape == (len(starts_np), 48)):
            raise AssertionError(f"float32 ingest kernel disagrees with its plain version on {name}")
        worst = max(worst, err)
    return worst


def random_epochs(np, B, seed, C=3, T=750, dc=300.0, noise=40.0):
    """(B, C, T) float32 epochs: noise around a per-epoch DC offset."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, C, T) * noise + rng.randn(B, C, 1) * dc).astype(np.float32)


def phase_epoch_cases(torch, np, dwt, dwt_cuda, wavelet, dev):
    """The epoch-features kernel against its plain version on the card:
    B = 1, 5, 37, 128 and 32,768; DC-heavy epochs; an all-zero epoch
    (an exactly zero row); 5-channel input reduced to 3 by the
    extractor's host gather; a window that does not fit raising."""
    cases = {f"B{B}": random_epochs(np, B, seed=B) for B in (1, 5, 37, 128, 32_768)}
    cases["dc_heavy"] = random_epochs(np, 300, seed=3, dc=3000.0, noise=15.0) + np.float32(2500.0)
    with_zero = random_epochs(np, 9, seed=4)
    with_zero[4] = 0.0
    cases["all_zero_epoch"] = with_zero
    worst = 0.0
    for name, x in cases.items():
        xt = torch.from_numpy(x).to(dev)
        got = dwt_cuda.epoch_features_cuda(xt)
        torch.cuda.synchronize()
        want = dwt.epoch_features(xt)
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        zero_row = name != "all_zero_epoch" or bool((got[4] == 0).all())
        emit("kernel_vs_plain", kernel="epoch_features", case=name, epochs=int(x.shape[0]),
             max_abs_err=err, tol=KERNEL_TOL, finite=finite, zero_row_exact=zero_row)
        if not (err <= KERNEL_TOL and finite and zero_row and got.shape == (x.shape[0], 48)):
            raise AssertionError(f"epoch-features kernel disagrees with its plain version on {name}")
        worst = max(worst, err)
    # 5 channels in, the configured (1, 2, 3) out: the gather is the host's
    five = random_epochs(np, 64, seed=5, C=5).astype(np.float64)
    fe = wavelet.WaveletTransform(backend="pallas", device=dev)
    got = fe.extract_batch(five)
    torch.cuda.synchronize()
    want = dwt.epoch_features(torch.from_numpy(five[:, :3].astype(np.float32)).to(dev))
    err = (got - want).abs().max().item()
    emit("kernel_vs_plain", kernel="epoch_features", case="five_channels_select_three",
         epochs=64, max_abs_err=err, tol=KERNEL_TOL, shape=list(got.shape))
    if not (err <= KERNEL_TOL and got.shape == (64, 48)):
        raise AssertionError("epoch-features kernel disagrees on 5-channel input")
    worst = max(worst, err)
    try:
        dwt_cuda.epoch_features_cuda(torch.zeros((2, 3, 600), device=dev))
    except ValueError as e:
        if "exceeds epoch length" not in str(e):
            raise
        emit("kernel_vs_plain", kernel="epoch_features", case="window_validation", raised=str(e))
    else:
        raise AssertionError("a 600-sample epoch did not raise")
    return worst


def margins_on_test_rows(builder):
    """(n_test,) float64 margins of a run's classifier on its test rows:
    the fused run's kept feature rows, or the host run's test epochs
    featurized again by its extractor."""
    import torch

    if builder.features is not None:
        idx = torch.as_tensor(builder.test_index, device=builder.features.device)
        feats = builder.features[idx]
    else:
        feats = builder.fe.extract_batch(builder.batch.epochs[builder.test_index])
    return builder.classifier.margin(feats).double().cpu().numpy()


def run_builder(label, query, device, counters):
    """One builder run with every named launch counter set to 0 just
    before it; returns (builder, statistics, {counter: launches})."""
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

    for module, attr in counters.values():
        setattr(module, attr, 0)
    t0 = time.perf_counter()
    builder = PipelineBuilder(query, device=device)
    stats = builder.execute()
    wall = time.perf_counter() - t0
    launches = {k: getattr(m, a) for k, (m, a) in counters.items()}
    emit("e2e", run=label, device=str(builder.device), launches=launches,
         rows=int(len(builder.targets)), accuracy=stats.calc_accuracy(),
         wall_s=wall, stages_s=builder.timers)
    return builder, stats, launches


def host_features_vs_plain(np, gpu, cpu, label):
    """A -pallas run's own train and test epochs through its extractor
    on the card, i.e. the epoch-features kernel at the shapes the run
    gave it, held against the plain version on the same float32 tensor
    and against the CPU run's extractor on the CPU run's epochs; returns
    the larger deviation. Called after the run's counts are read."""
    import torch

    from eeg_dataanalysispackage_tpu_torch.ops import dwt
    from eeg_dataanalysispackage_tpu_torch.utils import java_compat

    if gpu.batch.epochs.tobytes() != cpu.batch.epochs.tobytes():
        raise AssertionError(f"{label}: host epochs differ between the card and CPU runs")
    train_idx, _ = java_compat.train_test_split_indices(len(gpu.targets), seed=1)
    worst = 0.0
    for part, rows in (("train", train_idx), ("test", gpu.test_index)):
        rows = np.asarray(rows, dtype=np.int64)
        ep = gpu.batch.epochs[rows]
        if ep.shape[1:] != (3, 750):
            raise AssertionError(f"{label}: host epochs of shape {ep.shape}, not (n, 3, 750)")
        got = gpu.fe.extract_batch(ep)
        torch.cuda.synchronize()
        want = dwt.epoch_features(torch.from_numpy(ep.astype(np.float32)).to(got.device))
        on_cpu = cpu.fe.extract_batch(cpu.batch.epochs[rows])
        err_plain = (got - want).abs().max().item()
        err_cpu = (got.cpu() - on_cpu).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        emit("host_features_vs_plain", run=label, part=part, epochs=list(ep.shape),
             device=str(got.device), max_abs_err_plain=err_plain, max_abs_err_cpu=err_cpu,
             tol=KERNEL_TOL, finite=finite)
        if not (got.device.type == "cuda" and got.shape == (len(rows), 48) and finite
                and err_plain <= KERNEL_TOL and err_cpu <= KERNEL_TOL):
            raise AssertionError(f"{label}: {part} features disagree with the plain version")
        worst = max(worst, err_plain, err_cpu)
    return worst


def phase_host_path(np, info, counters):
    """The host fe= path on the card and the CPU: -pallas with logreg
    and svm, the host-float64 fe=dwt-8 and the on-card contraction
    -tpu, each against the port's CPU run; the -pallas logreg run's
    features against the plain version. Returns the epoch-features
    kernel's launches over the -pallas logreg run and the features'
    largest deviation."""
    runs = {}
    feat_err = None
    for fe in ("dwt-8-pallas", "dwt-8", "dwt-8-tpu"):
        for clf in (("logreg", "svm") if fe == "dwt-8-pallas" else ("logreg",)):
            q = f"info_file={info}&fe={fe}&train_clf={clf}"
            gpu = run_builder(f"{fe}_{clf}_cuda", q, None, counters)
            cpu = run_builder(f"{fe}_{clf}_cpu", q, "cpu", counters)
            if gpu[0].device.type != "cuda" or gpu[2]["ingest_features"] != 0:
                raise AssertionError(f"{fe} {clf}: not a host-epoch run on the card")
            if cpu[2]["epoch_features"] != 0:
                raise AssertionError(f"{fe} {clf}: the kernel launched on the CPU path")
            compare_runs(np, gpu[0], cpu[0], f"{fe}_{clf}")
            if (fe, clf) == ("dwt-8-pallas", "logreg"):
                feat_err = host_features_vs_plain(np, gpu[0], cpu[0], f"{fe}_{clf}")
            runs[(fe, clf)] = gpu
    k4 = runs[("dwt-8-pallas", "logreg")][2]["epoch_features"]
    if k4 != 2:
        raise AssertionError(f"-pallas logreg launched the epoch-features kernel {k4} times, not 2")
    for fe in ("dwt-8", "dwt-8-tpu"):
        if runs[(fe, "logreg")][2]["epoch_features"] != 0:
            raise AssertionError(f"{fe} launched the epoch-features kernel")
    return k4, feat_err


def phase_precision_runs(np, info, counters, f32_gpu, n_files):
    """fe=dwt-8-fused&precision=bf16|int8|int4&train_clf=logreg on the card
    and the CPU: the rung used as requested; the gate's f32 and rung
    launches plus one rung launch per recording; features against the
    CPU run's within KERNEL_TOL (int8/int4: except counted boundary flips,
    each one step); statistics under the near-threshold rule. Then an
    int4 run forced to trip its gate (EEG_TPU_INT4_GATE_TOL=1e-9 for that
    run only): f32 used, statistics equal to the card's f32 run. Returns
    {precision: launches of its instantiation}."""
    launches = {}
    for precision in ("bf16", "int8", "int4"):
        q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&precision={precision}"
        gpu = run_builder(f"logreg_{precision}_cuda", q, None, counters)
        cpu = run_builder(f"logreg_{precision}_cpu", q, "cpu", counters)
        counts, resolved = gpu[2], gpu[0].precision_resolved
        rung = f"ingest_features_{precision}"
        got, want = gpu[0].features.cpu(), cpu[0].features
        if precision == "bf16":
            flips, err = 0, (got - want).abs().max().item()
        else:
            flips, err = flip_check(np, got, want, f32_gpu.features.cpu(), precision,
                                    f"{precision} run")
        emit("precision_run", run=precision, precision_resolved=resolved, launches=counts,
             features_max_abs_err_vs_cpu=err, feature_flips_vs_cpu=flips, tol=KERNEL_TOL)
        others = {k: v for k, v in counts.items() if k not in (rung, "ingest_features")}
        if not (resolved["used"] == precision and counts[rung] == n_files + 1
                and counts["ingest_features"] == 1 and not any(others.values())
                and err <= KERNEL_TOL and got.shape == want.shape):
            raise AssertionError(f"precision={precision}: {resolved} {counts} err {err}")
        compare_runs(np, gpu[0], cpu[0], f"logreg_{precision}")
        launches[precision] = counts[rung]
    os.environ["EEG_TPU_INT4_GATE_TOL"] = "1e-9"
    try:
        q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&precision=int4"
        tripped = run_builder("logreg_int4_gate_tripped_cuda", q, None, counters)
    finally:
        del os.environ["EEG_TPU_INT4_GATE_TOL"]
    resolved, counts = tripped[0].precision_resolved, tripped[2]
    equal = str(tripped[1]) == str(f32_gpu.statistics)
    emit("precision_gate_tripped", precision_resolved=resolved, launches=counts,
         statistics_equal_f32_run=equal)
    if not (resolved["used"] == "f32" and not resolved["gate"]["ok"] and equal
            and counts["ingest_features"] == n_files + 1
            and counts["ingest_features_int4"] == 1):
        raise AssertionError(f"the tripped int4 gate did not run f32: {resolved} {counts}")
    return launches


def write_float_session(directory: str, n_files: int = 3, n_markers: int = 600) -> str:
    """IEEE_FLOAT_32 recordings (4 channels, Fz/Cz/Pz among them, marker
    stride 1,000) and their info.txt; returns the info.txt path."""
    import numpy as np

    lines = []
    for i in range(n_files):
        name, guessed = f"f32_{i:02d}", 1 + (i * 4) % 9
        rng = np.random.RandomState(500 + i)
        n_samples = 200 + n_markers * 1000 + 900
        x = rng.randn(n_samples, 4) * 30.0 + rng.randn(1, 4) * 500.0
        with open(os.path.join(directory, name + ".eeg"), "wb") as f:
            f.write(x.astype("<f4").tobytes())
        vhdr = ["Brain Vision Data Exchange Header File Version 1.0", "[Common Infos]",
                f"DataFile={name}.eeg", f"MarkerFile={name}.vmrk", "DataFormat=BINARY",
                "DataOrientation=MULTIPLEXED", "NumberOfChannels=4", "SamplingInterval=1000",
                "[Binary Infos]", "BinaryFormat=IEEE_FLOAT_32", "[Channel Infos]"]
        vhdr += [f"Ch{j + 1}={ch},,{res},uV"
                 for j, (ch, res) in enumerate(zip(("Fz", "Cz", "Pz", "Oz"), (1, 0.5, 1, 1)))]
        with open(os.path.join(directory, name + ".vhdr"), "w") as f:
            f.write("\n".join(vhdr) + "\n")
        vmrk = ["Brain Vision Data Exchange Marker File, Version 1.0", "[Marker Infos]"]
        vmrk += [f"Mk{k + 1}=Stimulus,S  {k % 9 + 1},{200 + k * 1000},1,0"
                 for k in range(n_markers)]
        with open(os.path.join(directory, name + ".vmrk"), "w") as f:
            f.write("\n".join(vmrk) + "\n")
        lines.append(f"{name}.eeg {guessed}")
    info = os.path.join(directory, "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


def phase_float_session(np, info, counters, n_files):
    """A float32 session through the fused path (the ingest kernel's
    float32 instantiation) and the -pallas path on the card, each
    against the port's CPU run: statistics, and the features the run's
    kernel made against the CPU run's (the plain version on the same
    inputs). Returns the float32 ingest kernel's launches over the fused
    run and the largest feature deviation of each kernel."""
    launches = {}
    for fe in ("dwt-8-fused", "dwt-8-pallas"):
        q = f"info_file={info}&fe={fe}&train_clf=logreg"
        gpu = run_builder(f"float32_{fe}_cuda", q, None, counters)
        cpu = run_builder(f"float32_{fe}_cpu", q, "cpu", counters)
        compare_runs(np, gpu[0], cpu[0], f"float32_{fe}")
        launches[fe] = gpu[2]
        if fe == "dwt-8-fused":
            f32_err = (gpu[0].features.cpu() - cpu[0].features).abs().max().item()
            emit("features_cuda_vs_cpu", run=f"float32_{fe}", rows=int(cpu[0].features.shape[0]),
                 max_abs_err=f32_err, tol=KERNEL_TOL)
            if not (f32_err <= KERNEL_TOL and gpu[0].features.shape == cpu[0].features.shape):
                raise AssertionError("the float32 session's card features disagree with the CPU run")
        else:
            k4_err = host_features_vs_plain(np, gpu[0], cpu[0], f"float32_{fe}")
    fused, pallas = launches["dwt-8-fused"], launches["dwt-8-pallas"]
    if fused["ingest_features_f32"] != n_files or fused["ingest_features"] != 0:
        raise AssertionError(f"the float32 session's fused run launched {fused}")
    if pallas["epoch_features"] != 2:
        raise AssertionError(f"the float32 session's -pallas run launched {pallas}")
    return fused["ingest_features_f32"], f32_err, k4_err


def timed_bound(bytes_moved, flops, bandwidth, f32_peak):
    """(bound ms, "bytes" or "operations")."""
    t_bytes, t_flops = bytes_moved / bandwidth * 1e3, flops / f32_peak * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def epoch_timing(torch, dwt, dwt_cuda, dev, n, bandwidth, f32_peak, smi):
    """The epoch-features kernel and its plain version on ``n`` (3, 750)
    float32 epochs; bound: the 512-sample windows read once, the rows
    written once, the operator read once."""
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((n, 3, 750), generator=gen, device=dev) * 40.0
    got = dwt_cuda.epoch_features_cuda(x)
    want = dwt.epoch_features(x)
    err = (got - want).abs().max().item()
    if err > KERNEL_TOL:
        raise AssertionError(f"epoch-features kernel disagrees at the timing size {n}: {err}")
    del got, want
    kernel_ms = time_ms(lambda: dwt_cuda.epoch_features_cuda(x))
    plain_ms = time_ms(lambda: dwt.epoch_features(x))
    device_ms = profiled_device_ms(lambda: dwt_cuda.epoch_features_cuda(x),
                                   "epoch_features_kernel")
    bytes_moved = n * 3 * 512 * 4 + n * 48 * 4 + 512 * 16 * 4
    flops = 2 * n * 3 * 512 * 16
    bound_ms, bound_by = timed_bound(bytes_moved, flops, bandwidth, f32_peak)
    emit("timing", kernel="epoch_features", epochs=n, kernel_ms=kernel_ms,
         kernel_device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
         bytes=bytes_moved, flops=flops, library_ms=None, max_abs_err=err, nvidia_smi=smi)
    return kernel_ms, plain_ms, bound_ms, bound_by, err


def ingest_timing(torch, ingest_cuda, device_ingest, W, dev, dtype, bandwidth, f32_peak, smi,
                  precision="f32"):
    """The fused ingest kernel at ``precision`` and its plain version at
    32,768 windows (3 channels, 1,000-sample stride) on an int16 or
    float32 stream; bound: the needed samples read once, rows, starts,
    operator and resolutions once (the rungs stream the same bytes).
    The int8/int4 rows are held bit for bit against the plain quantizer
    on the f32 kernel's rows, the others within KERNEL_TOL of the plain
    version."""
    n, stride = 32_768, 1000
    S = n * stride + 1000
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(-3000, 3000, (3, S), generator=gen, device=dev,
                        dtype=torch.int32).to(dtype)
    res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
    starts = (torch.arange(n, device=dev, dtype=torch.int32) * stride).contiguous()
    args = (raw, res, starts, W, 100, 175, precision)
    got = ingest_cuda.ingest_features(*args)
    if precision in ("int8", "int4"):
        f32 = ingest_cuda.ingest_features(raw, res, starts, W).cpu()
        err = (got.cpu() - quantizers()[precision](f32, 16)).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"{precision} epilogue differs from the quantizer: {err}")
    else:
        err = (got - device_ingest.ingest_features_plain(*args)).abs().max().item()
        if err > KERNEL_TOL:
            raise AssertionError(f"ingest kernel ({dtype}, {precision}) disagrees at the "
                                 f"timing size: {err}")
    del got
    kernel_ms = time_ms(lambda: ingest_cuda.ingest_features(*args))
    plain_ms = time_ms(lambda: device_ingest.ingest_features_plain(*args))
    device_ms = profiled_device_ms(lambda: ingest_cuda.ingest_features(*args),
                                   "ingest_features_kernel")
    samples = needed_samples(starts.cpu().numpy(), S, 100, 175, 512)
    bytes_moved = (3 * samples * raw.element_size() + n * 48 * 4 + n * 4 + W.numel() * 4
                   + 3 * 4)
    flops = 2 * n * 3 * 512 * 16
    bound_ms, bound_by = timed_bound(bytes_moved, flops, bandwidth, f32_peak)
    name = "ingest_features" if dtype == torch.int16 else "ingest_features_f32"
    if precision != "f32":
        name = f"ingest_features_{precision}"
    emit("timing", kernel=name, windows=n, stride=stride,
         stream_bytes=int(raw.numel() * raw.element_size()), kernel_ms=kernel_ms,
         kernel_device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
         bytes=bytes_moved, flops=flops, library_ms=None, max_abs_err=err, nvidia_smi=smi)
    return kernel_ms, plain_ms, bound_ms, bound_by, err


def mega_bound(n: int, bandwidth: float, f32_peak: float):
    """Least card time for the megakernel's function on ``n`` windows:
    the 612 needed int16 samples per channel and window read once, one
    float32 margin written per window, operator, weights and
    resolutions read once; against its float32 operations."""
    bytes_moved = 3 * n * (100 + 512) * 2 + n * 4 + 512 * 16 * 4 + 48 * 4 + 3 * 4
    flops = 2 * n * 3 * 512 * 16 + 2 * n * 48
    return (*timed_bound(bytes_moved, flops, bandwidth, f32_peak), bytes_moved, flops)


def mega_timing(torch, serve_mega, serve_mega_cuda, W, dev, n, bandwidth, f32_peak, smi,
                precision="f32"):
    """Megakernel (at ``precision``) and plain times on ``n`` full
    windows; int8/int4 margins are held against the quantized ingest
    kernel's rows of the same windows dotted with the weights."""
    from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda

    stride = serve_mega.padded_stride(100, 750)
    gen = torch.Generator(device=dev).manual_seed(n)
    stream = torch.randint(-3000, 3000, (3, n * stride), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int16)
    res = torch.tensor([0.1, 0.1, 0.2], dtype=torch.float32, device=dev)
    weights = torch.randn(48, generator=gen, device=dev, dtype=torch.float32)
    args = (stream, res, W, weights, 100, 175, stride, precision)
    got = serve_mega_cuda.serve_mega_margins(*args)
    if precision == "f32":
        want = serve_mega.serve_mega_margins_plain(*args)
    else:
        starts = torch.arange(n, dtype=torch.int32, device=dev) * stride
        want = ingest_cuda.ingest_features(stream, res, starts, W, 100, 175, precision) @ weights
    err = (got - want).abs().max().item()
    if err > MARGIN_TOL_PER_L1 * weights.abs().sum().item():
        raise AssertionError(f"megakernel ({precision}) disagrees at the timing size {n}: {err}")
    kernel_ms = time_ms(lambda: serve_mega_cuda.serve_mega_margins(*args))
    plain_ms = time_ms(lambda: serve_mega.serve_mega_margins_plain(*args))
    device_ms = profiled_device_ms(lambda: serve_mega_cuda.serve_mega_margins(*args),
                                   "serve_mega_kernel")
    bound_ms, bound_by, bytes_moved, flops = mega_bound(n, bandwidth, f32_peak)
    name = "serve_mega" if precision == "f32" else f"serve_mega_{precision}"
    emit("timing", kernel=name, windows=n, stride=stride, kernel_ms=kernel_ms,
         kernel_device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
         bytes=bytes_moved, flops=flops, library_ms=None, max_abs_err=err, nvidia_smi=smi)
    return kernel_ms, plain_ms, bound_ms, bound_by, err


def kernel_entry(name, source, replaces, launches, max_abs_err, timing):
    kernel_ms, plain_ms, bound_ms, bound_by = timing[:4]
    return {"name": name, "route": "cuda",
            "source": f"eeg_dataanalysispackage_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from eeg_dataanalysispackage_tpu_torch.features import wavelet
        from eeg_dataanalysispackage_tpu_torch.ops import (
            cuda_build, device_ingest, dwt, dwt_cuda, ingest_cuda, serve_mega, serve_mega_cuda,
        )
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
    build_kernels(cuda_build, ["ingest_features", "serve_mega", "epoch_features"])
    ingest_cuda.build()
    serve_mega_cuda.build()
    dwt_cuda.build()

    # 3. each kernel against its plain version
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)
    max_err = phase_kernel_cases(torch, np, ingest_cuda, device_ingest, W, dev)
    f32_err = phase_f32_stream_cases(torch, np, ingest_cuda, device_ingest, W, dev)
    mega_err = phase_mega_cases(torch, np, serve_mega, serve_mega_cuda, W, dev)
    epoch_err = phase_epoch_cases(torch, np, dwt, dwt_cuda, wavelet, dev)

    # 4. the batch paths end to end on an 8 x 1,200-marker session, and a
    # float32 session; every counter is set to 0 just before each run
    counters = {"ingest_features": (ingest_cuda, "LAUNCHES"),
                "ingest_features_f32": (ingest_cuda, "LAUNCHES_F32"),
                "ingest_features_bf16": (ingest_cuda, "LAUNCHES_BF16"),
                "ingest_features_int8": (ingest_cuda, "LAUNCHES_INT8"),
                "ingest_features_int4": (ingest_cuda, "LAUNCHES_INT4"),
                "epoch_features": (dwt_cuda, "LAUNCHES")}
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
            builder, _stats, launches = run_builder(label, query, device, counters)
            runs[label] = (builder, launches["ingest_features"])
            if device is None:
                if builder.features.device.type != "cuda" or launches["ingest_features"] < 8:
                    raise AssertionError(f"{label} did not run the kernel on the card")
            elif launches["ingest_features"] != 0:
                raise AssertionError(f"{label} launched the kernel on the CPU path")
        gpu, cpu = runs["logreg_cuda"][0], runs["logreg_cpu"][0]
        feat_err = (gpu.features.cpu() - cpu.features).abs().max().item()
        emit("features_cuda_vs_cpu", max_abs_err=feat_err, tol=KERNEL_TOL)
        if feat_err > KERNEL_TOL:
            raise AssertionError("card features disagree with the CPU run")
        compare_runs(np, gpu, cpu, "logreg")
        compare_runs(np, runs["svm_cuda"][0], runs["svm_cpu"][0], "svm")
        if str(runs["logreg_cuda_pallas_spelling"][0].statistics) != str(gpu.statistics):
            raise AssertionError("-fused-pallas spelling changed the statistics")
        main_launches = runs["logreg_cuda"][1]
        rung_launches = phase_precision_runs(np, info, counters, gpu, n_files=8)
        k4_launches, k4_path_err = phase_host_path(np, info, counters)

        float_dir = os.path.join(work, "float32")
        os.makedirs(float_dir)
        float_info = write_float_session(float_dir, n_files=3)
        f32_launches, f32_path_err, k4_f32_path_err = phase_float_session(
            np, float_info, counters, n_files=3)

        # 5. the serving path end to end with the card's saved model
        kept = int(len(gpu.targets))
        serve_launches, windows, resolutions = phase_serve(torch, np, info, model, kept)
        served_launches = phase_serve_precisions(np, info, model, kept, windows, resolutions)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 6. timing: the ingest kernel at 32,768 windows (int16 and float32
    # streams, and the bf16, int8 and int4 rungs on int16), the
    # megakernel (f32, int8, int4) at one serve batch and at 32,768
    # windows, the epoch-features kernel at 32,768 epochs
    k1 = ingest_timing(torch, ingest_cuda, device_ingest, W, dev, torch.int16,
                       bandwidth, f32_peak, smi)
    k1_f32 = ingest_timing(torch, ingest_cuda, device_ingest, W, dev, torch.float32,
                           bandwidth, f32_peak, smi)
    k1_rungs = {p: ingest_timing(torch, ingest_cuda, device_ingest, W, dev, torch.int16,
                                 bandwidth, f32_peak, smi, precision=p)
                for p in ("bf16", "int8", "int4")}
    mega_64, mega_big = ({p: mega_timing(torch, serve_mega, serve_mega_cuda, W, dev, n,
                                         bandwidth, f32_peak, smi, precision=p)
                          for p in ("f32", "int8", "int4")} for n in (64, 32_768))
    k4 = epoch_timing(torch, dwt, dwt_cuda, dev, 32_768, bandwidth, f32_peak, smi)

    # 7. the kernels line, then the card line, then the result
    ingest_pallas = "eeg_dataanalysispackage_tpu/ops/ingest_pallas.py:314"
    bank_pallas = "eeg_dataanalysispackage_tpu/ops/ingest_pallas.py:462"
    mega_pallas = "eeg_dataanalysispackage_tpu/ops/serve_mega.py:259"
    print(json.dumps({"kernels": [
        kernel_entry("ingest_features", "ingest_features.cu", ingest_pallas, main_launches,
                     max(max_err["f32"], k1[4]), k1),
        kernel_entry("serve_mega", "serve_mega.cu", mega_pallas, serve_launches,
                     max(mega_err["f32"], mega_64["f32"][4], mega_big["f32"][4]),
                     mega_64["f32"]),
        kernel_entry("epoch_features", "epoch_features.cu",
                     "eeg_dataanalysispackage_tpu/ops/dwt_pallas.py:44", k4_launches,
                     max(epoch_err, k4_path_err, k4_f32_path_err, k4[4]), k4),
        kernel_entry("ingest_features_f32", "ingest_features.cu", ingest_pallas, f32_launches,
                     max(f32_err, f32_path_err, k1_f32[4]), k1_f32),
        *(kernel_entry(f"ingest_features_{p}", "ingest_features.cu", bank_pallas,
                       rung_launches[p], max(max_err[p], k1_rungs[p][4]), k1_rungs[p])
          for p in ("bf16", "int8", "int4")),
        *(kernel_entry(f"serve_mega_{p}", "serve_mega.cu", mega_pallas, served_launches[p],
                       max(mega_err[p], mega_64[p][4], mega_big[p][4]), mega_64[p])
          for p in ("int8", "int4")),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
