"""The work of ALIKED-n16 + LightGlue, counted from the published
equations at the operands a batch had (`drivers/aliked_pairs.py` records
them under `ctx["deep"]`, as `drivers/deep_pairs.py` does: the pairs,
the image size, each image's valid keypoints, LightGlue's widths),
whatever implements it: a later kernel cannot move these counts.

Model FLOPs are 2 per multiply-accumulate of the convolutions and the
matrix products: ALIKED's regular and deformable convolutions (each
deformable one's 3x3 offset convolution too), the per-level 1x1
aggregation convolutions, the score head, and SDDH per valid keypoint
(its offset layers, `sf` on each sample, the aggregation);
LightGlue's through `deep_work.lightglue_macs`. Interpolation, sampling,
norms and activations are not counted, so no later change to the
upsampling or the gathers can move the count.

ALIKED is float32 throughout and runs against the float32 peak
(`bounds.PEAK_F32_OPS`), LightGlue against the dense TF32 peak
(`deep_work.PEAK_TF32_OPS`).
"""

from __future__ import annotations

from recbench.trace.bounds import PEAK_F32_OPS
from recbench.trace.deep_work import PEAK_TF32_OPS, _pairs, lightglue_macs

# aliked-n16's widths (cvg/LightGlue lightglue/aliked.py)
C1, C2, C3, C4, DIM, K, M = 16, 32, 64, 128, 128, 3, 16
OFFSETS = 2 * 9           # a deformable 3x3 conv's (dy, dx) per tap


def _conv(cin: int, cout: int, k: int) -> int:
    return cin * cout * k * k


def _deform(cin: int, cout: int) -> int:
    return _conv(cin, OFFSETS, 3) + _conv(cin, cout, 3)


# (MACs a pixel, resolution divisor) of each stage
ALIKED_STAGES = (
    # block1 at full resolution
    (_conv(3, C1, 3) + _conv(C1, C1, 3), 1),
    # block2 at 1/2: two 3x3 convs and the 1x1 shortcut
    (_conv(C1, C2, 3) + _conv(C2, C2, 3) + _conv(C1, C2, 1), 2),
    # block3 at 1/8 and block4 at 1/32: two deformable convs each
    (_deform(C2, C3) + _deform(C3, C3) + _conv(C2, C3, 1), 8),
    (_deform(C3, C4) + _deform(C4, C4) + _conv(C3, C4, 1), 32),
    # the per-level 1x1 aggregation convs, each at its level
    (_conv(C1, DIM // 4, 1), 1), (_conv(C2, DIM // 4, 1), 2),
    (_conv(C3, DIM // 4, 1), 8), (_conv(C4, DIM // 4, 1), 32),
    # the score head at full resolution
    (_conv(DIM, 8, 1) + _conv(8, 4, 3) + _conv(4, 4, 3) + _conv(4, 1, 3), 1),
)
# SDDH a keypoint: the K x K offset conv, the 1x1 after it, sf on each
# of the M samples, the (M, dim, dim) aggregation
SDDH_MACS = (_conv(DIM, 2 * M, K) + _conv(2 * M, 2 * M, 1)
             + M * DIM * DIM + M * DIM * DIM)


def aliked_dense_macs(height: int, width: int) -> float:
    """Multiply-accumulates of ALIKED-n16's dense network on one image,
    padded up to a multiple of 32."""
    h, w = height + (-height) % 32, width + (-width) % 32
    return float(sum(macs * (h // s) * (w // s) for macs, s in ALIKED_STAGES))


def batch_flops(op) -> tuple:
    """(ALIKED's, LightGlue's) model FLOPs of one recorded batch."""
    al = 2 * (2 * op["pairs"] * aliked_dense_macs(op["height"], op["width"])
              + sum(op["valid"]) * SDDH_MACS)
    lg = sum(2 * lightglue_macs(n0, n1, op["dim"], op["n_layers"],
                                op["heads"], op["input_dim"])
             for n0, n1 in _pairs(op))
    return al, lg


def least_s(op) -> float:
    """The least time of one recorded batch's model work: ALIKED's FLOPs
    at the float32 peak plus LightGlue's at the TF32 peak."""
    al, lg = batch_flops(op)
    return al / PEAK_F32_OPS + lg / PEAK_TF32_OPS
