"""Differential verification comparators.

The reference has no test framework; every parallel driver verifies against
an in-process serial oracle with one of three tolerance tiers
(SURVEY.md §4):

  * L2-norm of the diff <= 1.0      (simd.cpp:28-35, mpi.cpp:25-32)
  * NORM_INF (max abs diff) <= 1e-3 (openmp.cpp:27-33)
  * NORM_INF <= 1e-3 OR PSNR >= 30 dB relaxed pass (gpu.cpp:28-52)

This module reproduces all three tiers so the device drivers can verify the
same way, plus a structured report for the CLI.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

L2_TOL = 1.0
INF_TOL = 1e-3
PSNR_TOL_DB = 30.0


def l2_diff(a: np.ndarray, b: np.ndarray) -> float:
    """cv::norm(a, b, NORM_L2) analog: sqrt(sum((a-b)^2))."""
    return float(np.sqrt(np.sum((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def inf_diff(a: np.ndarray, b: np.ndarray) -> float:
    """cv::norm(a, b, NORM_INF) analog: max abs elementwise diff."""
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """PSNR in dB (gpu.cpp:36-49; peak=1.0 since pipeline output is [0,1])."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


@dataclass
class VerifyReport:
    l2: float
    inf: float
    psnr_db: float
    tier: str = ""
    passed: bool = False
    details: dict = field(default_factory=dict)

    def __str__(self) -> str:
        verdict = "[Success]" if self.passed else "[Error]"
        return (
            f"{verdict} tier={self.tier} L2={self.l2:.6f} "
            f"INF={self.inf:.6e} PSNR={self.psnr_db:.2f}dB"
        )


def channels_equal(
    ours: np.ndarray,
    oracle: np.ndarray,
    tier: str = "gpu",
) -> VerifyReport:
    """Compare restored channels against the oracle at a reference tier.

    tier: 'l2'   — L2 <= 1.0              (simd/mpi drivers)
          'inf'  — INF <= 1e-3            (openmp driver)
          'gpu'  — INF <= 1e-3 or PSNR>=30dB (gpu driver's relaxed pass)
    """
    ours = np.asarray(ours)
    oracle = np.asarray(oracle)
    if ours.shape != oracle.shape:
        return VerifyReport(
            l2=float("inf"), inf=float("inf"), psnr_db=0.0, tier=tier,
            passed=False, details={"shape_ours": ours.shape, "shape_oracle": oracle.shape},
        )

    def _check(a, b):
        l2 = l2_diff(a, b)
        inf = inf_diff(a, b)
        p = psnr(a, b)
        if tier == "l2":
            ok = l2 <= L2_TOL
        elif tier == "inf":
            ok = inf <= INF_TOL
        elif tier == "gpu":
            ok = (inf <= INF_TOL) or (p >= PSNR_TOL_DB)
        else:
            raise ValueError(f"unknown tier {tier!r}")
        return l2, inf, p, ok

    # The reference verifiers loop channels and require EVERY one to pass
    # (simd.cpp:66-79, gpu.cpp:28-55 compare channel Mats one at a time);
    # a joint-PSNR check could average a single bad channel away. Treat
    # leading axes as channels and report the worst one.
    if ours.ndim >= 3:
        chans = ours.reshape(-1, *ours.shape[-2:])
        ochans = oracle.reshape(-1, *oracle.shape[-2:])
        per = [_check(a, b) for a, b in zip(chans, ochans)]
        worst = min(range(len(per)), key=lambda i: per[i][2])  # lowest PSNR
        # joint metrics derived from the per-channel passes (equal-sized
        # planes): no second full-array traversal
        l2 = float(np.sqrt(sum(r[0] ** 2 for r in per)))
        inf = float(max(r[1] for r in per))
        mse = float(np.mean([10.0 ** (-r[2] / 10.0) for r in per]))
        p = float("inf") if mse == 0.0 else 10.0 * np.log10(1.0 / mse)
        ok = all(r[3] for r in per)
        details = {
            "per_channel": [
                {"l2": r[0], "inf": r[1], "psnr_db": r[2], "passed": r[3]}
                for r in per
            ],
            "worst_channel": worst,
        }
        return VerifyReport(
            l2=l2, inf=inf, psnr_db=p, tier=tier, passed=ok, details=details
        )
    l2, inf, p, ok = _check(ours, oracle)
    return VerifyReport(l2=l2, inf=inf, psnr_db=p, tier=tier, passed=ok)
