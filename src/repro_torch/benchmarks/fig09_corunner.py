"""Figures 9 and 10: effect of co-runners on SAD's mb_sad_calc block duration.

Fig. 9: 256 threads of different co-runners shift SAD's t by different
amounts (SHA1 largest).  Fig. 10: t grows with the number of co-resident
NLM2 blocks (paper: ~16k cycles alone to ~28k with 7 NLM2 blocks).

These figures characterise the simulator's duration model (the paper's are
measured from its simulator), so they are computed from the calibrated model
directly.
"""

from ..core.workload import ERCBENCH


def run():
    sad = ERCBENCH["SAD"]
    rows = []
    # Fig. 9: co-runner occupying 256 threads (= 8 warps), SAD at residency 4.
    fig9 = []
    for name in ("SHA1", "AES-e", "ImageDenoising-nlm2", "JPEG-d"):
        co = ERCBENCH[name]
        warps = co.corunner_pressure * 8.0      # 256 threads = 8 warps
        t = sad.duration(_RNG, residency=4, corunner_warps=warps)
        fig9.append(f"{name}={t:.0f}")
    rows.append(("fig09.sad_t_with_256thr_corunner", ";".join(fig9)))
    # Fig. 10: co-running NLM2 at 0..7 resident blocks (2 warps each).
    nlm2 = ERCBENCH["ImageDenoising-nlm2"]
    curve = []
    for n in range(8):
        warps = nlm2.corunner_pressure * n * nlm2.warps_per_block
        curve.append(f"{sad.duration(_RNG, 4, warps):.0f}")
    rows.append(("fig10.sad_t_vs_nlm2_blocks", ";".join(curve)))
    rows.append(("fig09.paper", "SHA1 shifts SAD's t the most"))
    rows.append(("fig10.paper", "~16k cycles alone -> ~28k with 7 NLM2 blocks"))
    return rows


class _NoNoise:
    def lognormal(self, mean=0.0, sigma=1.0):
        return 1.0


_RNG = _NoNoise()
