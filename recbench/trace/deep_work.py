"""The work of SuperPoint + LightGlue, counted from the published
equations at the operands a batch had (`drivers/deep_pairs.py` records
them: the pairs, the image size, each image's valid keypoints, the
widths), whatever implements it: a later kernel cannot move these counts.

Model FLOPs are 2 per multiply-accumulate of the convolutions and the
matrix products; the softmaxes, norms and activations are not counted.
LightGlue's least bytes are its parameters read once and, per pair, its
inputs read once, each layer's two views' states written once and read
once, and its outputs (row and column maxima, matchability, indices)
written once: no score matrix is counted, since none need reach memory.

The peak is NVIDIA's H100 SXM data sheet's dense TF32 rate, at the full
700 W power limit; the bandwidth is `bounds.py`'s.
"""

from __future__ import annotations

from recbench.trace.bounds import PEAK_BYTES_PER_S

PEAK_TF32_OPS = 494.7e12

# SuperPoint's convolutions: (input channels, output channels, kernel
# size, resolution divisor); the encoder, then the detector and
# descriptor heads on the 1/8 map
SUPERPOINT_CONVS = ((1, 64, 3, 1), (64, 64, 3, 1), (64, 64, 3, 2),
                    (64, 64, 3, 2), (64, 128, 3, 4), (128, 128, 3, 4),
                    (128, 128, 3, 8), (128, 128, 3, 8),
                    (128, 256, 3, 8), (256, 65, 1, 8),
                    (128, 256, 3, 8), (256, 256, 1, 8))


def superpoint_macs(height: int, width: int) -> float:
    """Multiply-accumulates of SuperPoint on one image, padded up to a
    multiple of 8."""
    h, w = height + (-height) % 8, width + (-width) % 8
    return float(sum(h // s * (w // s) * cin * cout * k * k
                     for cin, cout, k, s in SUPERPOINT_CONVS))


def lightglue_macs(n0: int, n1: int, dim: int, n_layers: int, heads: int,
                   input_dim: int) -> float:
    """Multiply-accumulates of LightGlue on one pair of n0 and n1
    keypoints: the input projection and positional encoding; per layer a
    self block on each view (packed q, k, v; q k^T and the weighted sum
    over all heads; the output projection; the FFN on concat(x, message):
    2d -> 2d -> d) and a cross block (q-and-k and v of both views, one
    similarity, both views' messages, the output projection and FFN);
    the final projection, the similarity and matchability."""
    d, n = dim, n0 + n1
    embed = n * input_dim * d + n * 2 * (d // heads // 2)
    ffn = 6 * d * d
    self_ = sum(x * (3 * d * d + d * d + ffn) + 2 * x * x * d
                for x in (n0, n1))
    cross = n * (3 * d * d + ffn) + 3 * n0 * n1 * d
    head = n * d * d + n0 * n1 * d + n * d
    return float(embed + n_layers * (self_ + cross) + head)


def lightglue_params(dim: int, n_layers: int, heads: int,
                     input_dim: int) -> int:
    d = dim
    ffn = 2 * d * 2 * d + 2 * d + 2 * 2 * d + 2 * d * d + d
    self_ = 3 * d * d + 3 * d + d * d + d + ffn
    cross = 3 * (d * d + d) + ffn
    posenc = 2 * (d // heads // 2)
    return (input_dim * d + d + posenc + n_layers * (self_ + cross)
            + d * d + d + d + 1)


def lightglue_bytes(n0: int, n1: int, dim: int, n_layers: int,
                    input_dim: int) -> float:
    """LightGlue's least bytes for one pair, its parameters left out."""
    n = n0 + n1
    inputs = n * (input_dim + 2) * 4
    layers = n_layers * 2 * n * dim * 4
    outputs = n * 4 * 3
    return float(inputs + layers + outputs)


def _pairs(op):
    B = op["pairs"]
    return [(op["valid"][b], op["valid"][B + b]) for b in range(B)]


def batch_flops(op) -> tuple:
    """(SuperPoint's, LightGlue's) model FLOPs of one recorded batch."""
    sp = 2 * op["pairs"] * 2 * superpoint_macs(op["height"], op["width"])
    lg = sum(2 * lightglue_macs(n0, n1, op["dim"], op["n_layers"],
                                op["heads"], op["input_dim"])
             for n0, n1 in _pairs(op))
    return sp, lg


def lightglue_bound_ms(op) -> float:
    """LightGlue's least time on one recorded batch: the larger of its
    FLOPs at the TF32 peak and its least bytes at the memory bandwidth."""
    flops = batch_flops(op)[1]
    bytes_ = 4 * lightglue_params(op["dim"], op["n_layers"], op["heads"],
                                  op["input_dim"])
    bytes_ += sum(lightglue_bytes(n0, n1, op["dim"], op["n_layers"],
                                  op["input_dim"]) for n0, n1 in _pairs(op))
    return max(flops / PEAK_TF32_OPS, bytes_ / PEAK_BYTES_PER_S) * 1e3
