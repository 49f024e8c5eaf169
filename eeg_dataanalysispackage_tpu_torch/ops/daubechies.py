"""Daubechies scaling-filter generation via spectral factorization.

The reference's DWT lives in the closed-source ``eegdsp`` jar
(WaveletTransform.java:108-136). The filter taps are *computed* here to
full double precision with mpmath:

  P(y) = sum_{k<N} C(N-1+k, k) y^k          (Daubechies polynomial)
  roots of P -> z-domain via y = (2 - z - 1/z)/4, keep |z| < 1
  m0(z) ~ ((1+z)/2)^N * prod (z - z_k)/(1 - z_k), normalized so
  sum(h) = sqrt(2)  (orthonormal convention).
"""

from __future__ import annotations

from functools import lru_cache

import mpmath as mp
import numpy as np


@lru_cache(maxsize=None)
def daubechies_scaling(n_vanishing: int, precision: int = 80) -> np.ndarray:
    """Orthonormal Daubechies scaling filter with ``n_vanishing``
    vanishing moments (2*n_vanishing taps), sum = sqrt(2)."""
    N = int(n_vanishing)
    if N < 1:
        raise ValueError("n_vanishing must be >= 1")
    if N == 1:  # Haar
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    with mp.workdps(precision):
        # Daubechies polynomial P(y), ascending powers
        coeffs = [mp.binomial(N - 1 + k, k) for k in range(N)]
        # polyroots wants descending order
        roots_y = mp.polyroots(list(reversed(coeffs)), maxsteps=200, extraprec=200)

        # Each y-root gives a quadratic in z: z^2 - (2 - 4y) z + 1 = 0.
        z_roots = []
        for y in roots_y:
            b = 2 - 4 * y
            disc = mp.sqrt(b * b - 4)
            z1 = (b + disc) / 2
            z2 = (b - disc) / 2
            z_roots.append(z1 if abs(z1) < 1 else z2)

        # Filter polynomial: ((1+z)/2)^N times prod (z - z_k)/(1 - z_k)
        poly = [mp.mpf(1)]
        for _ in range(N):
            poly = _polymul(poly, [mp.mpf(1), mp.mpf(1)])  # (1 + z)
        for z in z_roots:
            poly = _polymul(poly, [-z, mp.mpf(1)])  # (z - z_k) ascending

        # real part (conjugate roots pair up; imag parts cancel)
        poly = [mp.re(c) for c in poly]
        s = sum(poly)
        sqrt2 = mp.sqrt(2)
        h = [c / s * sqrt2 for c in poly]
        return np.array([float(c) for c in h], dtype=np.float64)


def _polymul(a, b):
    out = [mp.mpf(0)] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] += ai * bj
    return out
