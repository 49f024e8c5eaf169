#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path — ``PipelineBuilder('info_file=…&fe=dwt-8-fused
&train_clf=logreg').execute()`` — on the card, and holds every CUDA kernel
of that path against its plain PyTorch version. Phases, one JSON line
each:

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: compile every kernel from ``eeg_dataanalysispackage_tpu_torch/csrc``;
3. kernel against its plain version on the card (random, DC-heavy,
   overhanging, single-window, dense, odd-count and main-path-shaped
   inputs; max abs deviation <= 2e-6);
4. end to end: an 8-recording x 1,200-marker session through the
   builder with logreg, svm and the ``-fused-pallas`` spelling on the
   card; the kernel's launch count over the main-path run; statistics
   equal to the port's CPU run (a test row may differ only where its
   margin lies within 1e-4 of the threshold on both runs);
5. kernel timing at 32,768 windows (CUDA events, median of 25) beside
   the plain version's time and the card's bound.

Then the ``kernels`` line, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero with no
``ok`` line. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics as pystats
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 2e-6  # kernel vs plain version: summation orders only
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from eeg_dataanalysispackage_tpu_torch.ops import (
            cuda_build, device_ingest, dwt, ingest_cuda,
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

    # 2. build from the checkout's sources (a stale library is rebuilt)
    stale = cuda_build.library_path("ingest_features")
    if os.path.exists(stale):
        os.remove(stale)
    t0 = time.perf_counter()
    lib = ingest_cuda.build()
    ptxas = [ln.strip() for ln in cuda_build.BUILD_LOGS.get("ingest_features", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="ingest_features", seconds=time.perf_counter() - t0,
         library=os.path.relpath(lib, REPO), ptxas=ptxas)

    # 3. kernel against its plain version
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)
    max_err = phase_kernel_cases(torch, np, ingest_cuda, device_ingest, W, dev)

    # 4. end to end on an 8 x 1,200-marker session
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        info = write_session(work)
        emit("session", recordings=8, markers_each=1200, seconds=time.perf_counter() - t0)
        base = f"info_file={info}&result_path={work}/result.txt"
        runs = {}
        for label, query, device in (
            ("logreg_cuda", base + "&fe=dwt-8-fused&train_clf=logreg", None),
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
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 5. kernel timing at 32,768 windows, 1,000-sample stride, 3 channels
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
    emit("timing", windows=n, stride=stride, stream_bytes=int(raw.numel() * 2),
         kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
         bytes=bytes_moved, flops=flops, library_ms=None, max_abs_err=timing_err,
         nvidia_smi=smi)

    # 6. the kernels line, then the card line, then the result
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
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
