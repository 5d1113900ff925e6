"""Barotropic time-averaging filter weights.

Re-implements the power-law shape filter of the reference
(ROMS/Utility/set_weights.F:48-195) in host-side float64 (the reference uses
quad precision for the accumulations; float64 is ample for ndtfast <= 100 —
verified by the moment checks in tests/test_weights.py).

Returns primary weights w1 (used for <zeta>, <DU> fast-time averages) and
secondary weights w2 (used for the DU_avg2 flux average), normalized so
sum(w1) = sum(w2) = 1 with the w1 centroid exactly at ndtfast.
"""

from __future__ import annotations

import numpy as np

from .. import constants


def power_law_weights(ndtfast: int,
                      falpha: float = constants.Falpha,
                      fbeta: float = constants.Fbeta,
                      fgamma: float = constants.Fgamma):
    """Return (nfast, w1, w2); w1/w2 are float64 arrays of length 2*ndtfast.

    Follows set_weights.F:
      - shape F(xi) = xi^Falpha - xi^(Falpha+Fbeta) - gamma*xi,
        scale iterated 16x so the centroid lands near ndtfast (lines 70-95);
      - upstream-advection shift loop to place the centroid exactly
        (lines 131-169);
      - secondary weights from cumulative sums (lines 175-180);
      - normalization (lines 184-195).
    """
    nd = int(ndtfast)
    w1 = np.zeros(2 * nd, dtype=np.float64)   # w1[i] ~ weight(1,i+1)
    w2 = np.zeros(2 * nd, dtype=np.float64)

    scale = ((falpha + 1.0) * (falpha + fbeta + 1.0)
             / ((falpha + 2.0) * (falpha + fbeta + 2.0) * nd))
    gamma = fgamma * max(0.0, 1.0 - 10.0 / nd)
    nfast = 0
    for _ in range(16):
        nfast = 0
        for i in range(1, 2 * nd + 1):
            cff = scale * i
            w1[i - 1] = cff ** falpha - cff ** (falpha + fbeta) - gamma * cff
            if w1[i - 1] > 0.0:
                nfast = i
            if nfast > 0 and w1[i - 1] < 0.0:
                w1[i - 1] = 0.0
        wsum = w1[:nfast].sum()
        shift = (w1[:nfast] * np.arange(1, nfast + 1)).sum()
        scale = scale * shift / (wsum * nd)

    # Iteratively shift the center of gravity onto ndtfast exactly.
    for _ in range(nd):
        wsum = w1[:nfast].sum()
        shift = (w1[:nfast] * np.arange(1, nfast + 1)).sum() / wsum
        cff = nd - shift
        if cff > 1.0:
            nfast += 1
            w1[1:nfast] = w1[0:nfast - 1].copy()
            w1[0] = 0.0
        elif cff > 0.0:
            wsum = 1.0 - cff
            w1[1:nfast] = wsum * w1[1:nfast] + cff * w1[0:nfast - 1]
            w1[0] = wsum * w1[0]
        elif cff < -1.0:
            nfast -= 1
            w1[0:nfast] = w1[1:nfast + 1].copy()
            w1[nfast] = 0.0
        elif cff < 0.0:
            wsum = 1.0 + cff
            w1[0:nfast - 1] = wsum * w1[0:nfast - 1] - cff * w1[1:nfast]
            w1[nfast - 1] = wsum * w1[nfast - 1]

    # Secondary weights: w2[i] = sum_{j>=i} w1[j] before normalization
    # (set_weights.F:175-180: weight(2,i) += weight(1,j) for i<=j).
    for j in range(nfast):
        w2[:j + 1] += w1[j]

    w1[:nfast] /= w1[:nfast].sum()
    w2[:nfast] /= w2[:nfast].sum()
    return nfast, w1, w2
