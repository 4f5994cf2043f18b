"""The yardstick of the march kernel's roofline share, frozen here so that
no change to the program moves it.

The least time one H100 needs for the work a set of rays requires: the
larger of the operation bound (float32 operations at the float32 peak,
special-function operations at the SFU peak) and the byte bound (each
input read once, each output written once, at the HBM rate). The work is
counted by the plain reference (``oracle.march_rays(stats=...)``) in the
units below; the weights are a lower bound of the march's work per
counted unit for the simplex noise that the configurations state.
"""

from __future__ import annotations

# Published H100 SXM peaks at 700 W (NVIDIA's data sheet): float32 outside
# the tensor cores, the special-function units (16 per SM per clock, 132
# SMs at the 1.98 GHz boost clock) and HBM3.
F32_PEAK = 67e12
SFU_PEAK = 16 * 132 * 1.98e9
HBM_PEAK = 3.35e12

# (float32 ops, SFU ops) per counted unit: one op per add, sub, mul or
# compare-select; one SFU op per sqrt, divide, exp, sin, cos or atan
# reciprocal, two per pow.
WORK = {
    "samples": (83, 3),      # exit test, step, dott, radius, advance, floor;
                             # the ~22 float64 operations of the step's
                             # bookkeeping count twice (FP64 at half rate)
    "bulge": (58, 6),        # quat rotate, radius, pow, two sqrt, exp
    "triggers": (5, 1),      # |dott/z0| and the radial cutoff, per component
    "triggered": (14, 5),    # sech^2 and the intensity exp: the exact gates
    "gated": (18, 1),        # smoothstep, val, ival
    "arm_gated": (130, 13),  # two-arm pow ladder, atan2, winding
    "emitting": (40, 3),     # twirl (sin, cos, quat rotate), accumulate
    # one raw 3-D simplex evaluation: skew, 4 corners, gradients
    "raw_noise": (100, 0),
}
# bytes a ray's output takes: float32 linear radiance, 3 channels
OUT_BYTES_PER_RAY = 12


def bound_seconds(stats: dict, in_bytes: int, out_bytes: int) -> float:
    """The least seconds one H100 needs for the counted work."""
    ops = sum(stats.get(k, 0) * w[0] for k, w in WORK.items())
    sfu = sum(stats.get(k, 0) * w[1] for k, w in WORK.items())
    return max(ops / F32_PEAK, sfu / SFU_PEAK,
               (in_bytes + out_bytes) / HBM_PEAK)


def bound_for_rays(stats: dict, sampled_rays: int, rays: int) -> float:
    """The bound of ``rays`` rays, from the counts of ``sampled_rays``
    rays drawn uniformly from them, scaled to the whole."""
    scale = rays / sampled_rays
    return bound_seconds({k: v * scale for k, v in stats.items()}, 0,
                         rays * OUT_BYTES_PER_RAY)
