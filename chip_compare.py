#!/usr/bin/env python3
"""Compare the port's kernels of two checkouts on one NVIDIA card.

    python3 chip_compare.py OTHER_CHECKOUT

Shows, on the same card in one call, what a change to the CUDA sources
did to the kernels:

1. timing, in turns (other, this, this, other), each in a fresh process
   that builds its own checkout's kernels and calls that checkout's
   public wrappers on the same seeded inputs: the fused ingest kernel
   (``ingest_cuda.ingest_features``) on int16 and on float32 samples, the
   serve megakernel (``serve_mega_cuda.serve_mega_margins``), its
   tenant-stacked form K6 (``serve_mega_multi_margins``, lanes cycling
   over 128 tenants) and the epoch-features kernel
   (``dwt_cuda.epoch_features_cuda``), each at 64, at one recording's
   plan (the fused batch path's own launch: 320 rows of a staged
   1,200-marker recording, ``chip_smoke.recording_plan``; 320 windows for
   the others) and at 32,768 windows, the epoch-features kernel also at
   the ``-pallas`` logreg run's 641 and 1,494 epochs, and the precision
   rungs (the ingest kernel's bf16, int8 and int4 on the int16 stream, the
   megakernel's int8 and int4) at 32,768 windows; and the generic-size
   kernels (``*_any_kernel``) at each of ``chip_smoke.GENERIC_SIZES`` (3
   channels) at 4,096 windows, at ``chip_smoke.GENERIC_PATH_SIZE`` at one
   serve batch of 64, and at ``chip_smoke.GENERIC_WIDE`` on 256 windows of
   76 channels (names ending ``c76``): K1-any at every rung and on float32 samples,
   K5-any at f32, int8 and int4, K6-any on the f32, int8 and int4 stacks
   (kernel names ``<kernel>@<epoch>x<features>``); where a checkout's
   megakernel takes float32 samples, every megakernel case above also on
   the same windows scaled into float32 (kernel names ending ``_f32s``). One JSON line each: the kernel's
   device time per call from ``torch.profiler`` (``device_ms``, 20 calls,
   ``chip_smoke.profiled_device_ms``), the median CUDA-event time of one
   wrapper call (``event_ms``, 25 calls, ``chip_smoke.time_ms``), the
   wall time per call of 200 back-to-back calls, host work included
   (``call_ms``, median of 5), the median host time of one call, the card
   not waited for (``host_ms``, 200 calls) and a sha256 of the output,
   tagged with the checkout; each checkout's generic tile plans at those
   sizes on int16 and float32 samples (``generic_plans``: fields, design
   and shared memory); in this checkout's turns, both designs of the
   generic engine at each generic case (``design_times``: K1-any, K5-any
   and K6-any at f32 on int16 and float32 samples, each launched with the
   phase-by-phase design's plan and with the ring design's, their device
   times, modelled clocks, the design the plan picks and whether their
   outputs are bit-equal); and the generic fused path's wall
   (``load_features_device`` of an 8-recording session at
   ``GENERIC_PATH_SIZE``, three times in the process:
   ``generic_path_wall``);
2. ``outputs``: one line per kernel and size with ``bit_equal``, the
   checkouts' output digests compared;
3. the SASS of every kernel instantiation both builds have (``cuobjdump
   -sass``), compared instruction by instruction, addresses left out: one
   JSON line per instantiation with ``identical`` and ``f32``; an
   instantiation only this build has is listed as ``new``; a generic-size
   instantiation's line has ``generic: true`` (its SASS changes with the
   generic engine); and the ``ptxas`` registers and spills of every kernel
   each build made, and the registers, barriers and spills of each generic
   instantiation by key (``ptxas_generic``, printed before the timings).

An instantiation is keyed by its kernel and template arguments, not by
its mangled name (which carries a hash of its source file and its
parameter list): the sample type (the megakernel's float32 samples as
``_f32s``; its int16 samples, and a megakernel without the sample
argument, alike), the precision
(``window_features::Precision``), the megakernel's ``kMulti``, the
wide-ring ``kWide``, the tenant stack's precision (``Weights``; the f32
stack where a build has none), a generic kernel's design (``_d0`` the
phase-by-phase design, ``_d1`` the ring design; a checkout without the
argument ran ``_d0`` on int16 samples and ``_d1`` on float32 ones), the
epoch-features kernel's ``kMain`` and ``kL``. It counts as f32 at precision 0 (``kF32``) on an f32 stack.

Where this checkout has the quantized tenant stack's kernels (K6-w8,
K6-w4) and the other does not, they are timed here alone, and each
output is held against K6 on the dequantized stack
(``bit_equal_k6_dequantized``). Exits non-zero when a build, a timing or
``cuobjdump`` fails. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("ingest_features", "serve_mega", "epoch_features")
_KERNEL = re.compile(r"(ingest_features_kernelI[sf]|serve_mega_kernel_tiles|serve_mega_kernel"
                     r"|epoch_features_kernel|ingest_features_any_kernelI[sf]"
                     r"|serve_mega_any_kernel)")
#: the capacities at which both designs of the float32-sample megakernel
#: at 512 / 16 are timed (``mega_design_times``)
MEGA_DESIGN_SIZES = (64, 320, 1024, 4096, 32_768)
SIZES = (64, 320, 32_768)
EPOCH_RUN_SIZES = (641, 1494)


def float_mega(serve_mega_cuda) -> bool:
    """Whether a checkout's megakernel takes float32 samples (it has the
    float32-sample instantiations' counters)."""
    return hasattr(serve_mega_cuda, "LAUNCHES_F32S")


def smoke_helpers():
    """This checkout's ``chip_smoke.py`` as a module (not the timed tree's:
    an older one may lack its helpers); what it imports of the package
    resolves to the timed tree."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_checkout(tree: str, label: str) -> None:
    """Build ``tree``'s kernels and print its f32 timings (one process)."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    from eeg_dataanalysispackage_tpu_torch.ops import (
        cuda_build, dwt, dwt_cuda, ingest_cuda, serve_mega, serve_mega_cuda,
    )

    def emit(**fields):
        print(json.dumps({"checkout": label, **fields}), flush=True)

    libs = {name: cuda_build.build(name) for name in SOURCES}
    ptxas = {name: [ln.strip() for ln in cuda_build.BUILD_LOGS.get(name, "").splitlines()
                    if "registers" in ln or "spill" in ln] for name in SOURCES}
    emit(phase="libraries", libraries=libs, ptxas=ptxas,
         ptxas_generic=generic_ptxas(cuda_build.BUILD_LOGS))
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)

    cs = smoke_helpers()
    # the float32-sample generic launches' tile plans (shared memory and
    # fields) at the timed sizes, as this tree plans them
    from eeg_dataanalysispackage_tpu_torch.ops import generic_plan

    limits = ingest_cuda.device_limits(dev)
    emit(phase="generic_plans", plans={
        f"{C}x{e}x{K}@{n}/{sample_bytes}B": dict(
            generic_plan.generic_tile_plan(C, e, K, n, *limits, 100, sample_bytes)._asdict())
        for (e, K, _skip), n, C in ([(size, n, 3) for size in cs.GENERIC_SIZES
                                     for n in (4096, 64)] + [(cs.GENERIC_WIDE, 256, 76)])
        for sample_bytes in (2, 4)})

    def run(kernel, symbol, size, fn):
        out = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        # the profiler now and then drops kernel records: a second round
        # of retakes before giving up
        device = (cs.profiled_device_ms(fn, symbol, runs=20)
                  or cs.profiled_device_ms(fn, symbol, runs=20))
        if device is None:
            raise RuntimeError(f"the profiler saw no device time for {symbol}")
        emit(phase="timing", kernel=kernel, windows=size, device_ms=device,
             event_ms=cs.time_ms(fn), call_ms=call_ms(fn), host_ms=host_ms(fn), sha256=digest,
             nvidia_smi=smi)

    # the fused ingest kernel: the plan's first 64 rows (the gate's launch),
    # the plan (chip_smoke.py's first session recording, staged and planned
    # by the timed tree), and 32,768 windows at a 1,000-sample stride
    work = tempfile.mkdtemp(prefix="chip_compare_")
    try:
        raw, res, plan_starts, _kept = cs.recording_plan(cs.write_session(work, n_files=1), dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    big_S = 32_768 * 1000 + 1000
    gen = torch.Generator(device=dev).manual_seed(0)
    big = torch.randint(-3000, 3000, (3, big_S), generator=gen, device=dev, dtype=torch.int32)
    big_starts = torch.arange(32_768, device=dev, dtype=torch.int32) * 1000
    for dtype, kernel in ((torch.int16, "ingest_features"), (torch.float32, "ingest_features_f32")):
        if dtype == torch.int16:
            plan_raw, plan_res, big_raw = raw, res, big.to(torch.int16)
            big_res = torch.tensor([0.1, 0.1, 0.2], device=dev)
        else:  # a float32 recording is staged already scaled, unit resolutions
            plan_raw = (raw.to(torch.float32) * res[:, None]).contiguous()
            plan_res = torch.ones(3, device=dev)
            big_raw, big_res = (big.to(torch.float32) * 0.1).contiguous(), torch.ones(3, device=dev)
        for size, (r, rs, st) in zip(SIZES, ((plan_raw, plan_res, plan_starts[:64].contiguous()),
                                             (plan_raw, plan_res, plan_starts),
                                             (big_raw, big_res, big_starts))):
            run(kernel, "ingest_features_kernel", size,
                lambda r=r, rs=rs, st=st: ingest_cuda.ingest_features(r, rs, st, W))
        if dtype == torch.int16:  # the precision rungs at 32,768 windows
            for p in ("bf16", "int8", "int4"):
                run(f"ingest_features_{p}", "ingest_features_kernel", SIZES[-1],
                    lambda p=p: ingest_cuda.ingest_features(big_raw, big_res, big_starts, W,
                                                            100, 175, p))
        del big_raw

    # the megakernel and K6 on full windows at the serve stride; a
    # checkout whose megakernel takes float32 samples also times its
    # float32-sample instantiations on the same windows scaled by the
    # resolutions (``_f32s``)
    stride = serve_mega.padded_stride(100, 750)
    sample_types = ("int16", "float32") if float_mega(serve_mega_cuda) else ("int16",)
    for n, samples in [(n, s) for n in SIZES for s in sample_types]:
        suffix = "_f32s" if samples == "float32" else ""
        gen = torch.Generator(device=dev).manual_seed(n)
        stream = torch.randint(-3000, 3000, (3, n * stride), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int16)
        sres = torch.tensor([0.1, 0.1, 0.2], device=dev)
        if samples == "float32":
            stream = (stream.to(torch.float32) * sres[:, None]).contiguous()
            sres = torch.ones(3, device=dev)
        weights = torch.randn(48, generator=gen, device=dev)
        stack = torch.randn((serve_mega.MAX_TENANTS, 48), generator=gen, device=dev)
        lanes = torch.arange(n, dtype=torch.int32) % serve_mega.MAX_TENANTS
        run("serve_mega" + suffix, "serve_mega_kernel", n,
            lambda: serve_mega_cuda.serve_mega_margins(stream, sres, W, weights, 100, 175, stride))
        for p in ("int8", "int4") if n == SIZES[-1] else ():
            run(f"serve_mega_{p}{suffix}", "serve_mega_kernel", n,
                lambda p=p: serve_mega_cuda.serve_mega_margins(stream, sres, W, weights, 100, 175,
                                                               stride, p))
        run("serve_mega_multi" + suffix, "serve_mega_kernel", n,
            lambda: serve_mega_cuda.serve_mega_multi_margins(stream, sres, W, stack, lanes, 100,
                                                             175, stride))
        if hasattr(serve_mega_cuda, "serve_mega_multi_packed_margins"):
            from eeg_dataanalysispackage_tpu_torch.ops import quant

            for wp in ("int8", "int4"):
                packed_np, scales_np = quant.quantize_weight_stack(
                    stack.t().cpu().numpy(), wp)
                packed = torch.from_numpy(np.ascontiguousarray(packed_np.T)).to(dev)
                scales = torch.from_numpy(scales_np).to(dev)
                deq = quant.dequantize_weight_stack(packed.t(), scales, wp, 48).t().contiguous()
                k6 = serve_mega_cuda.serve_mega_multi_margins(stream, sres, W, deq, lanes, 100,
                                                              175, stride)
                fn = (lambda packed=packed, scales=scales, wp=wp:
                      serve_mega_cuda.serve_mega_multi_packed_margins(
                          stream, sres, W, packed, scales, lanes, 100, 175, stride, wp))
                equal = fn().cpu().numpy().tobytes() == k6.cpu().numpy().tobytes()
                emit(phase="packed_vs_k6", kernel=f"serve_mega_multi_{wp}{suffix}", windows=n,
                     bit_equal_k6_dequantized=equal)
                run(f"serve_mega_multi_{wp}{suffix}", "serve_mega_kernel", n, fn)
        del stream

    # the epoch-features kernel on (n, 3, 750) float32 epochs, also at the
    # -pallas logreg run's own launches (641 and 1,494 epochs)
    for n in sorted((*SIZES, *EPOCH_RUN_SIZES)):
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((n, 3, 750), generator=gen, device=dev) * 40.0
        run("epoch_features", "epoch_features_kernel", n, lambda: dwt_cuda.epoch_features_cuda(x))

    time_generic(cs, run, dev)
    if label == "this":
        time_designs(cs, emit, dev, smi)
        time_mega_designs(cs, emit, dev, smi)
    time_generic_path(cs, emit, smi)


def call_ms(fn, calls: int = 200, repeats: int = 5) -> float:
    """Wall time (ms) per call of ``calls`` back-to-back calls of ``fn``,
    the card synchronized once at the end: the wrapper's host work and
    the kernel as a loop of calls pays them (a call's host work overlaps
    the previous kernel). Median of ``repeats``."""
    import statistics
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / calls * 1e3)
    return statistics.median(walls)


def host_ms(fn, calls: int = 200, every: int = 20) -> float:
    """Median host time (ms) of one call of ``fn``: the wrapper's work up
    to the kernel's enqueue, the card not waited for (synchronized,
    untimed, every ``every`` calls so the queue stays short)."""
    import statistics
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        if i % every == every - 1:
            torch.cuda.synchronize()
    return statistics.median(times)


def time_generic_path(cs, emit, smi, repeats: int = 3) -> None:
    """The generic fused path end to end through the timed tree:
    ``load_features_device`` of an 8-recording session at
    ``chip_smoke.GENERIC_PATH_SIZE`` (f32), ``repeats`` times in this
    process (the first call pays first-use costs), each one's wall."""
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider

    n, K, skip = cs.GENERIC_PATH_SIZE
    work = tempfile.mkdtemp(prefix="chip_compare_path_")
    try:
        info = cs.write_session(work)
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            feats, _targets = OfflineDataProvider([info]).load_features_device(
                8, n, skip, K, precision="f32")
            feats.cpu()
            walls.append(time.perf_counter() - t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(phase="generic_path_wall", epoch_size=n, feature_size=K, rows=int(feats.shape[0]),
         wall_s=walls, nvidia_smi=smi)


def time_generic(cs, run, dev) -> None:
    """The generic-size kernels through the timed tree's wrappers: at each
    of ``chip_smoke.GENERIC_SIZES`` on 4,096 windows of 3 channels, at
    ``GENERIC_PATH_SIZE`` on one serve batch of 64 windows, and at
    ``GENERIC_WIDE`` on 256 windows of 76 channels (tag ``c76``): K1-any at
    every rung on an int16 stream (1,000-sample stride) and f32 on a
    float32 one, K5-any at f32/int8/int4 and K6-any on the f32, int8 and
    int4 stacks at the serve stride (lanes cycling over 128 tenants)."""
    import numpy as np
    import torch

    from eeg_dataanalysispackage_tpu_torch.ops import (
        dwt, ingest_cuda, quant, serve_mega, serve_mega_cuda,
    )

    stride = serve_mega.padded_stride(100, 750)
    cases = ([(size, 4096, 3) for size in cs.GENERIC_SIZES] + [(cs.GENERIC_PATH_SIZE, 64, 3)]
             + [(cs.GENERIC_WIDE, 256, 76)])
    for (e, K, skip), n, C in cases:
        tag = f"@{e}x{K}" + ("" if C == 3 else f"c{C}")
        res = (torch.tensor([0.1, 0.1, 0.2], device=dev) if C == 3
               else torch.full((C,), 0.1, device=dev))
        ones = torch.ones(C, device=dev)
        gen = torch.Generator(device=dev).manual_seed(n + e + K)
        W = dwt.kernel_operator(8, e, K, dev)
        big = torch.randint(-3000, 3000, (C, n * 1000 + 1000), generator=gen, device=dev,
                            dtype=torch.int32)
        raw, raw_f = big.to(torch.int16), (big.to(torch.float32) * 0.1).contiguous()
        starts = torch.arange(n, device=dev, dtype=torch.int32) * 1000
        for p in ("f32", "bf16", "int8", "int4"):
            run("ingest_features_any" + ("" if p == "f32" else f"_{p}") + tag,
                "ingest_features_any_kernel", n,
                lambda p=p: ingest_cuda.ingest_features(raw, res, starts, W, 100, skip, p, e, K))
        run("ingest_features_any_f32" + tag, "ingest_features_any_kernel", n,
            lambda: ingest_cuda.ingest_features(raw_f, ones, starts, W, 100, skip, "f32", e, K))
        stream16 = torch.randint(-3000, 3000, (C, n * stride), generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.int16)
        weights = torch.randn(C * K, generator=gen, device=dev)
        stack = torch.randn((serve_mega.MAX_TENANTS, C * K), generator=gen, device=dev)
        lanes = torch.arange(n, dtype=torch.int32) % serve_mega.MAX_TENANTS
        packed = {}
        for wp in ("int8", "int4"):
            packed_np, scales_np = quant.quantize_weight_stack(stack.t().cpu().numpy(), wp)
            packed[wp] = (torch.from_numpy(np.ascontiguousarray(packed_np.T)).to(dev),
                          torch.from_numpy(scales_np).to(dev))
        for samples in ("int16", "float32") if float_mega(serve_mega_cuda) else ("int16",):
            suffix = "_f32s" if samples == "float32" else ""
            stream, sres = stream16, res
            if samples == "float32":
                stream = (stream16.to(torch.float32) * res[:, None]).contiguous()
                sres = ones
            for p in ("f32", "int8", "int4"):
                run("serve_mega_any" + ("" if p == "f32" else f"_{p}") + suffix + tag,
                    "serve_mega_any_kernel", n,
                    lambda p=p, stream=stream, sres=sres: serve_mega_cuda.serve_mega_margins(
                        stream, sres, W, weights, 100, skip, stride, p, e, K))
            run("serve_mega_multi_any" + suffix + tag, "serve_mega_any_kernel", n,
                lambda stream=stream, sres=sres: serve_mega_cuda.serve_mega_multi_margins(
                    stream, sres, W, stack, lanes, 100, skip, stride, e, K))
            for wp, (pk, scales) in packed.items():
                run(f"serve_mega_multi_any_{wp}" + suffix + tag, "serve_mega_any_kernel", n,
                    lambda pk=pk, scales=scales, wp=wp, stream=stream, sres=sres:
                    serve_mega_cuda.serve_mega_multi_packed_margins(
                        stream, sres, W, pk, scales, lanes, 100, skip, stride, wp, e, K))


def time_designs(cs, emit, dev, smi) -> None:
    """Both designs of the generic engine at each case of
    :func:`time_generic` (``design_times``): K1-any at f32 on int16 and
    float32 samples, K5-any at f32 and K6-any on the f32 stack on int16 and
    float32 samples, each launched with the plan of the phase-by-phase
    design, then the ring design's (``generic_plan.design_plans``): each
    one's device time (``profiled_device_ms``, 20 calls), the modelled
    clocks of both plans, the design the plan picks, and whether both
    designs' outputs are bit-equal."""
    import numpy as np
    import torch

    from eeg_dataanalysispackage_tpu_torch.ops import (
        dwt, generic_plan, ingest_cuda, serve_mega, serve_mega_cuda,
    )

    plan_of = generic_plan.generic_tile_plan
    limits = ingest_cuda.device_limits(dev)
    stride = serve_mega.padded_stride(100, 750)
    cases = ([(size, 4096, 3) for size in cs.GENERIC_SIZES] + [(cs.GENERIC_PATH_SIZE, 64, 3)]
             + [(cs.GENERIC_WIDE, 256, 76)])
    try:
        for (e, K, skip), n, C in cases:
            tag = f"@{e}x{K}" + ("" if C == 3 else f"c{C}")
            res = torch.full((C,), 0.1, device=dev)
            ones = torch.ones(C, device=dev)
            gen = torch.Generator(device=dev).manual_seed(n + e + K)
            W = dwt.kernel_operator(8, e, K, dev)
            big = torch.randint(-3000, 3000, (C, n * 1000 + 1000), generator=gen, device=dev,
                                dtype=torch.int32)
            starts = torch.arange(n, device=dev, dtype=torch.int32) * 1000
            stream16 = torch.randint(-3000, 3000, (C, n * stride), generator=gen, device=dev,
                                     dtype=torch.int32).to(torch.int16)
            weights = torch.randn(C * K, generator=gen, device=dev)
            stack = torch.randn((serve_mega.MAX_TENANTS, C * K), generator=gen, device=dev)
            lanes = torch.arange(n, dtype=torch.int32) % serve_mega.MAX_TENANTS
            for samples in ("int16", "float32"):
                sb = 2 if samples == "int16" else 4
                suffix = "" if samples == "int16" else "_f32s"
                raw = big.to(torch.int16) if sb == 2 else (big.to(torch.float32) * 0.1).contiguous()
                stream = (stream16 if sb == 2
                          else (stream16.to(torch.float32) * 0.1).contiguous())
                rs = res if sb == 2 else ones
                kernels = (
                    ("ingest_features_any" + ("" if sb == 2 else "_f32") + tag,
                     "ingest_features_any_kernel",
                     lambda: ingest_cuda.ingest_features(raw, rs, starts, W, 100, skip, "f32", e,
                                                         K)),
                    ("serve_mega_any" + suffix + tag, "serve_mega_any_kernel",
                     lambda: serve_mega_cuda.serve_mega_margins(stream, rs, W, weights, 100, skip,
                                                                stride, "f32", e, K)),
                    ("serve_mega_multi_any" + suffix + tag, "serve_mega_any_kernel",
                     lambda: serve_mega_cuda.serve_mega_multi_margins(stream, rs, W, stack, lanes,
                                                                      100, skip, stride, e, K)),
                )
                plans = generic_plan.design_plans(C, e, K, n, *limits, 100, sb)
                chosen = plan_of(C, e, K, n, *limits, 100, sb)
                for kernel, symbol, fn in kernels:
                    times, digests = {}, {}
                    for design, name in enumerate(generic_plan.DESIGNS):
                        generic_plan.generic_tile_plan = (
                            lambda *a, design=design: generic_plan.design_plans(*a)[design][0])
                        out = fn()
                        torch.cuda.synchronize()
                        digests[name] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
                        times[name] = (cs.profiled_device_ms(fn, symbol, runs=20)
                                       or cs.profiled_device_ms(fn, symbol, runs=20))
                    generic_plan.generic_tile_plan = plan_of
                    emit(phase="design_times", kernel=kernel, windows=n, device_ms=times,
                         clocks={name: clocks for name, (_p, clocks)
                                 in zip(generic_plan.DESIGNS, plans)},
                         plans={name: list(p.fields()) for name, (p, _c)
                                in zip(generic_plan.DESIGNS, plans)},
                         chosen=generic_plan.DESIGNS[chosen.design],
                         designs_bit_equal=len(set(digests.values())) == 1, nvidia_smi=smi)
    finally:
        generic_plan.generic_tile_plan = plan_of


def time_mega_designs(cs, emit, dev, smi) -> None:
    """Both designs of the float32-sample megakernel at 512 / 16
    (``serve_mega_cuda.MEGA_DESIGNS``: run_windows and the tile design) at
    each of :data:`MEGA_DESIGN_SIZES` windows, every rung and stack (K5-f32s
    at f32, int8 and int4, K6-f32s on the f32, int8 and int4 stacks), each
    launched with each design forced (``mega_design_times``): its device
    time (``profiled_device_ms``, 20 calls), the design the launch picks,
    and whether both designs' margins are bit-equal. Where the crossover
    (``serve_mega_cuda.TILES_WINDOWS_PER_SM``) is decided."""
    import numpy as np
    import torch

    from eeg_dataanalysispackage_tpu_torch.ops import (
        dwt, ingest_cuda, quant, serve_mega, serve_mega_cuda,
    )

    pick = serve_mega_cuda.mega_design
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)
    stride = serve_mega.padded_stride(100, 750)
    limits = ingest_cuda.device_limits(dev)
    try:
        for n in MEGA_DESIGN_SIZES:
            gen = torch.Generator(device=dev).manual_seed(n + 7)
            stream = (torch.randint(-3000, 3000, (3, n * stride), generator=gen, device=dev,
                                    dtype=torch.int32).to(torch.float32) * 0.1).contiguous()
            ones = torch.ones(3, device=dev)
            weights = torch.randn(48, generator=gen, device=dev)
            stack = torch.randn((serve_mega.MAX_TENANTS, 48), generator=gen, device=dev)
            lanes = torch.arange(n, dtype=torch.int32) % serve_mega.MAX_TENANTS
            kernels = {
                f"serve_mega{'' if p == 'f32' else '_' + p}_f32s":
                    (lambda p=p: serve_mega_cuda.serve_mega_margins(
                        stream, ones, W, weights, 100, 175, stride, p))
                for p in ("f32", "int8", "int4")}
            kernels["serve_mega_multi_f32s"] = lambda: serve_mega_cuda.serve_mega_multi_margins(
                stream, ones, W, stack, lanes, 100, 175, stride)
            for wp in ("int8", "int4"):
                pk, sc = quant.quantize_weight_stack(stack.t().cpu().numpy(), wp)
                pk = torch.from_numpy(np.ascontiguousarray(pk.T)).to(dev)
                sc = torch.from_numpy(sc).to(dev)
                kernels[f"serve_mega_multi_{wp}_f32s"] = (
                    lambda pk=pk, sc=sc, wp=wp: serve_mega_cuda.serve_mega_multi_packed_margins(
                        stream, ones, W, pk, sc, lanes, 100, 175, stride, wp))
            chosen = pick(n, 3, *limits, 100, stride)
            for kernel, fn in kernels.items():
                times, digests = {}, {}
                for design, name in enumerate(serve_mega_cuda.MEGA_DESIGNS):
                    serve_mega_cuda.mega_design = lambda *a, design=design: design
                    out = fn()
                    torch.cuda.synchronize()
                    digests[name] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
                    times[name] = (cs.profiled_device_ms(fn, "serve_mega_kernel", runs=20)
                                   or cs.profiled_device_ms(fn, "serve_mega_kernel", runs=20))
                serve_mega_cuda.mega_design = pick
                emit(phase="mega_design_times", kernel=kernel, windows=n, device_ms=times,
                     chosen=serve_mega_cuda.MEGA_DESIGNS[chosen],
                     designs_bit_equal=len(set(digests.values())) == 1, nvidia_smi=smi)
            del stream
    finally:
        serve_mega_cuda.mega_design = pick


def generic_ptxas(logs: dict) -> dict:
    """{generic instantiation key: {registers, spill_stores, spill_loads}}
    from the ``ptxas -v`` logs of this process's builds."""
    out, current = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                keyed = instantiation_key(m.group(1))
                current = keyed[0] if keyed and "_any_kernel" in keyed[0] else None
                continue
            if current is None:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                out.setdefault(current, {}).update(spill_stores=int(spill.group(1)),
                                                   spill_loads=int(spill.group(2)))
            regs = re.search(r"Used (\d+) registers(?:, used (\d+) barriers)?", line)
            if regs:
                out.setdefault(current, {})["registers"] = int(regs.group(1))
                if regs.group(2):
                    out[current]["barriers"] = int(regs.group(2))
    return out


def instantiation_key(name: str):
    """(key, f32) of a kernel's mangled name, or None for a kernel not
    compared: the kernel and its template arguments, without the source
    file's hash or the parameter list."""
    key = _KERNEL.search(name)
    if not key:
        return None
    current = key.group(1)
    # the float32-sample megakernel's tile design keys as the megakernel
    # with ``_t1`` (its template arguments: the precision, kMulti, the
    # stack's precision); run_windows' keys are unchanged
    tiles = current == "serve_mega_kernel_tiles"
    if tiles:
        current = "serve_mega_kernel"
    precision = re.search(r"9PrecisionE(\d)E", name)
    weights = re.search(r"7WeightsE(\d)E", name)
    p = int(precision.group(1)) if precision else 0
    w = int(weights.group(1)) if weights else 0
    # bool template arguments: the megakernel's kMulti, then run_windows'
    # kWide (an older checkout may lack kWide); the epoch-features
    # kernel's kMain (an older one has none)
    flags = re.findall(r"Lb([01])E", name)
    if current == "epoch_features_kernel":
        lanes = re.search(r"epoch_features_kernel_smallILi(\d+)E", name)
        if lanes:
            current += f"_small_{lanes.group(1)}"
        elif flags:
            current += "_main" if flags[0] == "1" else "_any_size"
        flags = []
    if current in ("serve_mega_kernel", "serve_mega_any_kernel") and flags and flags.pop(0) == "1":
        current += "_multi"
    if flags and flags[0] == "1":
        current += "_wide"
    if precision:
        current += f"_p{p}"
    if current.startswith(("serve_mega_kernel_multi", "serve_mega_any_kernel_multi")):
        current += f"_w{w}"
    # the megakernel's sample type: float32 (template argument f) keys
    # apart; int16 (s) and a checkout whose megakernel has no sample
    # argument key alike
    if re.search(r"serve_mega(?:_any)?_kernelIf", name) or tiles:
        current += "_f32s"
    if tiles:
        current += "_t1"
    # a generic kernel's design (its int template argument); a checkout
    # without one ran the phase-by-phase design on int16 samples and, once
    # it had a float32-sample engine, the ring design on float32 ones
    if "_any_kernel" in current:
        design = re.search(r"Li(\d+)E", name)
        if design:
            current += f"_d{design.group(1)}"
        else:
            current += "_d1" if re.search(r"_any_kernelIf", name) else "_d0"
    return current, p == 0 and w == 0


def kernel_sass(cuobjdump: str, library: str) -> dict:
    """{instantiation key: (f32, [instruction text])} of a library's
    kernels."""
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                         check=True).stdout
    kernels, current = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            keyed = instantiation_key(m.group(1))
            current = keyed[0] if keyed else None
            if current:
                kernels[current] = (keyed[1], [])
            continue
        if current and "/*" in line:
            text = re.sub(r"/\*[0-9a-f]{4}\*/", "", line.split(";")[0]).strip()
            if text:
                kernels[current][1].append(text)
    return kernels


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--time":
        time_checkout(os.path.abspath(argv[2]), argv[3])
        return 0
    if len(argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    other = os.path.abspath(argv[1])
    libraries, digests = {}, {}
    # each tree's first turn builds its kernels afresh, so its ptxas lines
    # are printed; later turns load them
    for tree in (other, HERE):
        shutil.rmtree(os.path.join(tree, "eeg_dataanalysispackage_tpu_torch", "_build"),
                      ignore_errors=True)
    for label, tree in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", tree, label],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            record = json.loads(line)
            if record["phase"] not in ("timing", "libraries"):
                print(line, flush=True)  # packed_vs_k6, generic_plans, design_times, ...
                continue
            if record["phase"] == "libraries":
                libraries[label] = record["libraries"]
                if any(record["ptxas"].values()):
                    print(json.dumps({"phase": "ptxas", "checkout": label,
                                      "ptxas": record["ptxas"]}), flush=True)
                generic = record.get("ptxas_generic", {})
                if generic:
                    print(json.dumps({"phase": "ptxas_generic", "checkout": label,
                                      "kernels": generic,
                                      "no_spills": all(not k.get("spill_stores")
                                                       and not k.get("spill_loads")
                                                       for k in generic.values())}), flush=True)
                continue
            digests.setdefault((record["kernel"], record["windows"]), {}).setdefault(
                label, set()).add(record["sha256"])
            print(line, flush=True)
    for (kernel, windows), by in sorted(digests.items()):
        if "other" not in by:
            print(json.dumps({"phase": "outputs", "kernel": kernel, "windows": windows,
                              "new": True, "digests_stable": len(by["this"]) == 1}), flush=True)
            continue
        print(json.dumps({"phase": "outputs", "kernel": kernel, "windows": windows,
                          "bit_equal": len(by["other"] | by["this"]) == 1,
                          "generic": "_any" in kernel}), flush=True)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name in SOURCES:
        sass = {label: kernel_sass(cuobjdump, libraries[label][name]) for label in libraries}
        for key in sorted(set(sass["other"]) | set(sass["this"])):
            generic = "_any_kernel" in key
            if key not in sass["other"]:
                print(json.dumps({"phase": "sass", "kernel": key, "new": True,
                                  "f32": sass["this"][key][0], "generic": generic,
                                  "instructions_this": len(sass["this"][key][1])}), flush=True)
                continue
            (f32, a), (_, b) = sass["other"][key], sass["this"].get(key, (None, []))
            print(json.dumps({"phase": "sass", "kernel": key, "f32": f32, "identical": a == b,
                              "generic": generic, "instructions_other": len(a),
                              "instructions_this": len(b)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
