#!/usr/bin/env python3
"""Compare the port's f32 kernels of two checkouts on one NVIDIA card.

    python3 chip_compare.py OTHER_CHECKOUT

Shows whether a change to the CUDA sources left the f32 kernels alone,
on the same card in one call:

1. timing, in turns (other, this, this, other), each in a fresh process
   that builds its own checkout's kernels and runs that checkout's
   ``chip_smoke.py`` timing helpers: the fused ingest kernel at 32,768
   windows on an int16 and a float32 stream, the serve megakernel at
   capacity 64 and 32,768, the epoch-features kernel at 32,768 epochs
   (CUDA events and ``torch.profiler`` device time, one JSON line each,
   tagged with the checkout);
2. the f32 kernels' SASS (``cuobjdump -sass`` of both builds), compared
   instruction by instruction, addresses left out: one JSON line per
   kernel with ``identical``.

A kernel counts as f32 when its name carries no precision template
argument or precision 0 (``window_features::Precision::kF32``); the serve
megakernel's tenant-stacked instantiation (``kMulti``) is keyed apart
from the one-vector kernel, so each is compared with its own. Exits
non-zero when a build, a timing or ``cuobjdump`` fails. Needs one card;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("ingest_features", "serve_mega", "epoch_features")
_KERNEL = re.compile(r"(ingest_features_kernelI[sf]|serve_mega_kernel|epoch_features_kernel)")


def time_checkout(tree: str, label: str) -> None:
    """Build ``tree``'s kernels and print its f32 timings (one process)."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from eeg_dataanalysispackage_tpu_torch.ops import (
        cuda_build, device_ingest, dwt, dwt_cuda, ingest_cuda, serve_mega, serve_mega_cuda,
    )

    cs.emit = lambda phase, **f: print(json.dumps({"checkout": label, "phase": phase, **f}),
                                       flush=True)
    libs = {name: cuda_build.build(name) for name in SOURCES}
    print(json.dumps({"checkout": label, "phase": "libraries", "libraries": libs}), flush=True)
    dev = torch.device("cuda")
    bw, flops = cs.card_peaks(torch.cuda.get_device_name(0))
    smi = cs.nvidia_smi_line()
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)
    for dtype in (torch.int16, torch.float32):
        cs.ingest_timing(torch, ingest_cuda, device_ingest, W, dev, dtype, bw, flops, smi)
    for n in (64, 32_768):
        cs.mega_timing(torch, serve_mega, serve_mega_cuda, W, dev, n, bw, flops, smi)
    cs.epoch_timing(torch, dwt, dwt_cuda, dev, 32_768, bw, flops, smi)


def f32_sass(cuobjdump: str, library: str) -> dict:
    """{kernel key: [instruction text]} of a library's f32 kernels."""
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                         check=True).stdout
    kernels, current = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            key = _KERNEL.search(name)
            f32 = "Precision" not in name or "PrecisionE0E" in name
            current = key.group(1) if key and f32 else None
            if current and "Lb1E" in name:  # a true bool flag: the kMulti instantiation
                current += "_multi"
            if current:
                kernels[current] = []
            continue
        if current and "/*" in line:
            text = re.sub(r"/\*[0-9a-f]{4}\*/", "", line.split(";")[0]).strip()
            if text:
                kernels[current].append(text)
    return kernels


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--time":
        time_checkout(os.path.abspath(argv[2]), argv[3])
        return 0
    if len(argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    other = os.path.abspath(argv[1])
    libraries = {}
    for label, tree in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", tree, label],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            record = json.loads(line)
            if record["phase"] == "libraries":
                libraries[label] = record["libraries"]
            else:
                print(line, flush=True)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name in SOURCES:
        sass = {label: f32_sass(cuobjdump, libraries[label][name]) for label in libraries}
        for key in sorted(sass["other"]):
            a, b = sass["other"][key], sass["this"].get(key, [])
            print(json.dumps({"phase": "sass_f32", "kernel": key, "identical": a == b,
                              "instructions_other": len(a), "instructions_this": len(b)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
