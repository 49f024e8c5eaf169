"""Fused int16 ingest, three formulations.

Usage::

    python -m eeg_dataanalysispackage_tpu_torch.examples.fused_ingest [--device cpu] [--n 256]

Generates a synthetic int16 multiplexed recording with stimulus markers
and produces 48-dim DWT feature vectors straight from the raw stream (no
host epoch tensors):

1. the plain PyTorch version (``ops/device_ingest.ingest_features_plain``):
   an index gather of every window, the baseline mean in float64, one
   einsum with the cascade matrix, L2-normalize;
2. the fused ingest kernel K1 (``ops/ingest_cuda.ingest_features_cuda``,
   ``csrc/ingest_features.cu``) on the same markers: windows cut, centred,
   contracted and normalized in one launch (its plain version on the CPU);
3. a regular stimulus train (``make_regular_ingest_featurizer``): a fixed
   stimulus-onset asynchrony, K1 at ``first + k * stride``.

The first two agree to float32 summation order.
"""

import sys

import numpy as np

from . import k1_launches, kernel_line, parser

RESOLUTIONS = np.array([0.1, 0.1, 0.2], np.float32)


def run(device=None, n: int = 256, stride: int = 800, first: int = 200) -> dict:
    """The three formulations on one seeded recording; returns their rows
    (on the device), the inputs, max|Δ| of K1 against the plain rows and
    K1's launches."""
    from ..ops import device_ingest, dwt, ingest_cuda
    from ..utils import constants
    from ..utils.device import host_to_device, resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    S = 200 + n * stride + 1000
    raw = rng.randint(-3000, 3000, size=(3, S), dtype=np.int16)
    positions = (200 + stride * np.arange(n)
                 + rng.randint(-150, 150, size=n)).astype(np.int64)
    raw_t, res_t = host_to_device(raw, dev), host_to_device(RESOLUTIONS, dev)
    before = k1_launches()
    # 1. irregular markers through the plain PyTorch version
    starts = host_to_device((positions - constants.PRESTIMULUS_SAMPLES).astype(np.int32), dev)
    feats_plain = device_ingest.ingest_features_plain(raw_t, res_t, starts,
                                                      dwt.kernel_operator(8, 512, 16, dev))
    # 2. the same markers through the fused ingest kernel
    feats_k1 = ingest_cuda.ingest_features_cuda(raw_t, res_t, positions)
    # 3. regular stimulus train: K1 at first + k * stride
    reg = device_ingest.make_regular_ingest_featurizer(stride, n, device=dev)
    feats_reg = reg(raw_t, res_t, first)
    return {"device": str(dev), "raw": raw, "resolutions": RESOLUTIONS,
            "positions": positions, "regular_positions": first + stride * np.arange(n),
            "plain": feats_plain, "k1": feats_k1, "regular": feats_reg,
            "formulation": reg.formulation,
            "max_abs_diff": float((feats_k1 - feats_plain).abs().max()),
            "k1_launches": k1_launches() - before}


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=256, help="markers (default 256)")
    ap.add_argument("--stride", type=int, default=800)
    args = ap.parse_args(argv)
    out = run(args.device, args.n, args.stride)
    plain = out["plain"].cpu().numpy()
    print(f"plain version : {plain.shape}  norm[0]={np.linalg.norm(plain[0]):.6f}")
    print(f"K1 kernel     : {tuple(out['k1'].shape)}  "
          f"max|Δ| vs plain = {out['max_abs_diff']:.2e}")
    print(f"regular train : {tuple(out['regular'].shape)}  "
          f"(K1 at first + k*stride, formulation {out['formulation']!r})")
    print(kernel_line(out["k1_launches"], out["device"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
