"""LightGlue: the attention matcher, weight-compatible with the published
checkpoints.

Port of `tpu3drec/models/lightglue.py`, layer for layer:

- `input_proj` Linear(input_dim -> d); a learnable Fourier positional
  encoding (`posenc.Wr`, 2 -> head_dim / 2, no bias) applied as rotary
  embeddings with interleaved (cos, sin) pairs;
- `transformers[i]`: a self block (packed `Wqkv`, unflattened as
  (N, dh, h, 3); rotary q and k; out_proj; an FFN [Linear(2d, 2d),
  LayerNorm eps 1e-5, exact GELU, Linear(2d, d)] on concat(x, message))
  shared by both views, then a cross block (one `to_qk` for both views,
  scaled by dh^-0.25 on each side, one similarity and a softmax over each
  of its axes);
- the last assignment head: `final_proj` / d^0.25 on both sides, the
  similarity, matchability logits, a double log-softmax and log-sigmoid
  gating. It runs in float32 whatever the activation type.

The self and cross blocks' attention goes through
`ops/attention.py:masked_attention`: on the CPU the plain composition,
on the card the one-pass kernel `csrc/masked_attention.cu`, which writes
no score tensor (TF32, or 3xTF32 under `matmul_precision="highest"`). Padded keypoints are masked out of every softmax with
-1e9, not -inf, so a row whose keys are all masked gets a uniform softmax,
never NaN. The paper's adaptive depth and width pruning is left out, as in
the reference. Every function takes a leading batch axis.

While a profiler records, the network runs under the spans
`lightglue.embed` (input projection, positional encoding),
`lightglue.self` (a layer's self blocks), `lightglue.cross` (its cross
block), `lightglue.attention` (each `masked_attention` call, inside the
last two) and `lightglue.assign` (the assignment head), each opened by
`utils/profiling.py:span`.

`match_features_lightglue` is the registry's matcher: it loads
`WEIGHTS_DIR/lightglue_d{D}.npz`, then `lightglue.npz`, for the
descriptors' dimension D (a cache keyed by D), and raises ImportError
when no file fits, so the pipeline records a kNN fallback.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu3drec_torch.core.types import Features, Matches, ScoreType
from tpu3drec_torch.models import _params
from tpu3drec_torch.models._common import (
    activation_dtype as dtype_named, activations, precision,
)
from tpu3drec_torch.ops.attention import NEG, masked_attention
from tpu3drec_torch.utils.profiling import span



def normalize_keypoints(xy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Shift by the size / 2, scale by max(size) / 2."""
    shift = torch.tensor([w / 2.0, h / 2.0], dtype=torch.float32,
                         device=xy.device)
    return (xy - shift) / (max(h, w) / 2.0)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(..., 2k): each pair (x0, x1) -> (-x1, x0), interleaved layout."""
    x2 = x.unflatten(-1, (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)


def apply_rotary(t: torch.Tensor, cos_i: torch.Tensor,
                 sin_i: torch.Tensor) -> torch.Tensor:
    """t (..., N, h, dh); cos_i, sin_i (..., N, dh) as [c0, c0, c1, c1, ..]."""
    return t * cos_i[..., None, :] + rotate_half(t) * sin_i[..., None, :]


class FourierPE(nn.Module):
    """Learnable Fourier features -> the interleaved (cos, sin) tables
    shared by every head."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.Wr = nn.Linear(2, head_dim // 2, bias=False)

    def forward(self, xy_norm):
        proj = self.Wr(xy_norm)
        return (torch.cos(proj).repeat_interleave(2, dim=-1),
                torch.sin(proj).repeat_interleave(2, dim=-1))


def _ffn(dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(2 * dim, 2 * dim),
                         nn.LayerNorm(2 * dim, eps=1e-5), nn.GELU(),
                         nn.Linear(2 * dim, dim))


class SelfBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.Wqkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ffn = _ffn(dim)

    def forward(self, x, cos_i, sin_i, mask):
        """x (B, N, d); mask (B, N) marks valid keys."""
        B, n, _ = x.shape
        dh = self.dim // self.heads
        qkv = self.Wqkv(x).reshape(B, n, dh, self.heads, 3)
        q, k, v = (qkv[..., i].transpose(-1, -2) for i in range(3))
        q = apply_rotary(q, cos_i, sin_i)                 # (B, N, h, dh)
        k = apply_rotary(k, cos_i, sin_i)
        with span("lightglue.attention"):
            ctx = masked_attention(q, k, v, mask, 1 / math.sqrt(dh))
        ctx = ctx.reshape(B, n, self.dim)
        return x + self.ffn(torch.cat([x, self.out_proj(ctx)], dim=-1))


class CrossBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.to_qk = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)
        self.ffn = _ffn(dim)

    def forward(self, x0, x1, mask0, mask1):
        B = x0.shape[0]
        h = self.heads
        dh = self.dim // h
        scale = dh ** -0.25
        qk0 = self.to_qk(x0).reshape(B, -1, h, dh) * scale
        qk1 = self.to_qk(x1).reshape(B, -1, h, dh) * scale
        v0 = self.to_v(x0).reshape(B, -1, h, dh)
        v1 = self.to_v(x1).reshape(B, -1, h, dh)
        # the similarity's softmax over each axis, one direction a call:
        # qk carries dh^-0.25 on each side, so the scale is 1
        with span("lightglue.attention"):
            m0 = masked_attention(qk0, qk1, v1, mask1, 1.0)
        with span("lightglue.attention"):
            m1 = masked_attention(qk1, qk0, v0, mask0, 1.0)
        m0 = self.to_out(m0.reshape(B, -1, self.dim))
        m1 = self.to_out(m1.reshape(B, -1, self.dim))
        return (x0 + self.ffn(torch.cat([x0, m0], dim=-1)),
                x1 + self.ffn(torch.cat([x1, m1], dim=-1)))


class GlueLayer(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.self_attn = SelfBlock(dim, heads)
        self.cross_attn = CrossBlock(dim, heads)

    def forward(self, d0, d1, pe0, pe1, mask0, mask1):
        with span("lightglue.self"):
            d0 = self.self_attn(d0, *pe0, mask0)
            d1 = self.self_attn(d1, *pe1, mask1)
        with span("lightglue.cross"):
            return self.cross_attn(d0, d1, mask0, mask1)


class LightGlueNet(nn.Module):
    """`forward(desc0, desc1, xy0, xy1, mask0, mask1)` on (B, N, ...)
    batches, keypoints normalised -> (log_assign (B, N0, N1), sim, z0,
    z1), the matchability gating applied."""

    def __init__(self, input_dim: int = 256, dim: int = 256,
                 n_layers: int = 9, heads: int = 4):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.input_proj = nn.Linear(input_dim, dim)
        self.posenc = FourierPE(dim // heads)
        self.transformers = nn.ModuleList(
            [GlueLayer(dim, heads) for _ in range(n_layers)])
        self.final_proj = nn.Linear(dim, dim)
        self.matchability = nn.Linear(dim, 1)

    def forward(self, desc0, desc1, xy0, xy1, mask0, mask1):
        with span("lightglue.embed"):
            d0 = self.input_proj(desc0)
            d1 = self.input_proj(desc1)
            pe0, pe1 = self.posenc(xy0), self.posenc(xy1)
        for layer in self.transformers:
            d0, d1 = layer(d0, d1, pe0, pe1, mask0, mask1)
        # the assignment head scores in float32 (or wider) whatever the
        # activations
        with span("lightglue.assign"), \
                torch.autocast(d0.device.type, enabled=False):
            wide = torch.promote_types(d0.dtype, torch.float32)
            d0, d1 = d0.to(wide), d1.to(wide)
            f0 = self.final_proj(d0) / self.dim ** 0.25
            f1 = self.final_proj(d1) / self.dim ** 0.25
            sim = torch.einsum("bnd,bmd->bnm", f0, f1)
            z0 = self.matchability(d0)[..., 0]
            z1 = self.matchability(d1)[..., 0]
            sim = sim.masked_fill(~mask0[:, :, None], NEG)
            sim = sim.masked_fill(~mask1[:, None, :], NEG)
            log_assign = (F.log_softmax(sim, dim=2)
                          + F.log_softmax(sim.transpose(1, 2), dim=2)
                          .transpose(1, 2)
                          + F.logsigmoid(z0)[:, :, None]
                          + F.logsigmoid(z1)[:, None, :])
        return log_assign, sim, z0, z1


def _batched(f: Features) -> Features:
    return f if f.xy.ndim == 3 else f.replace(
        xy=f.xy[None], response=f.response[None], scale=f.scale[None],
        angle=f.angle[None], desc=f.desc[None], mask=f.mask[None])


def assignment_matches(log_assign: torch.Tensor, mask0: torch.Tensor,
                       mask1: torch.Tensor, filter_threshold: float) -> Matches:
    """The mutual argmax of `exp(log_assign)` (B, N0, N1) with confidence
    above `filter_threshold` between valid keypoints."""
    p = torch.exp(log_assign)
    best1 = torch.argmax(p, dim=2)                      # (B, N0)
    best0 = torch.argmax(p, dim=1)                      # (B, N1)
    idx = torch.arange(p.shape[1], device=p.device)
    mutual = best0.gather(1, best1) == idx
    conf = p.max(dim=2).values
    ok = mutual & (conf > filter_threshold) & mask0 & mask1.gather(1, best1)
    return Matches(idx1=idx.to(torch.int32).expand_as(best1),
                   idx2=best1.to(torch.int32),
                   score=torch.where(ok, conf, torch.zeros_like(conf)),
                   mask=ok, score_type=ScoreType.CONFIDENCE.value,
                   method="lightglue")


class LightGlue:
    """Inference wrapper producing Matches with confidence scores;
    `matmul_precision` and `activation_dtype` as in
    `models.superpoint.SuperPoint`."""

    def __init__(self, net: Optional[LightGlueNet] = None, dim: int = 256,
                 n_layers: int = 9, heads: int = 4, input_dim: int = 256,
                 matmul_precision: str = "default",
                 activation_dtype: str = "float32"):
        self.config = dict(input_dim=input_dim, dim=dim, n_layers=n_layers,
                           heads=heads)
        self.net = net
        self.matmul_precision = matmul_precision
        self.dtype = dtype_named(activation_dtype)

    def init_random(self, generator: torch.Generator) -> LightGlueNet:
        self.net = _params.init_random(LightGlueNet(**self.config),
                                       generator).eval()
        return self.net

    @torch.no_grad()
    def forward(self, desc0, desc1, xy0, xy1, mask0, mask1):
        """The network under this wrapper's precision and activations."""
        with precision(self.matmul_precision), \
                activations(self.dtype, desc0.device):
            return self.net(desc0, desc1, xy0, xy1, mask0, mask1)

    @torch.no_grad()
    def match(self, feats0: Features, feats1: Features,
              filter_threshold: float = 0.1) -> Matches:
        """Mutual argmax of the assignment with confidence above
        `filter_threshold` between valid keypoints; a batch of pairs when
        the Features carry a leading batch axis."""
        if self.net is None:
            raise RuntimeError("LightGlue weights not loaded; call "
                               "init_random() for testing")
        single = feats0.xy.ndim == 2
        f0, f1 = _batched(feats0), _batched(feats1)

        def norm_xy(f):
            h, w = (f.image_shape or (480, 640))[:2]
            return normalize_keypoints(f.xy, h, w)

        log_assign, _, _, _ = self.forward(f0.desc, f1.desc, norm_xy(f0),
                                           norm_xy(f1), f0.mask, f1.mask)
        m = assignment_matches(log_assign, f0.mask, f1.mask, filter_threshold)
        if single:
            m = m.replace(idx1=m.idx1[0], idx2=m.idx2[0], score=m.score[0],
                          mask=m.mask[0])
        return m


# -- checkpoints ------------------------------------------------------------

def load_torch_weights(state_dict: Dict[str, Any], n_layers: int = 9) -> Dict:
    """A cvg/LightGlue state dict (bare or `matcher.`-prefixed names) ->
    the reference's flax variables {"params": tree}. Only the last
    assignment head is kept (the others serve the early exits)."""
    sd = {(k[8:] if k.startswith("matcher.") else k): v
          for k, v in state_dict.items()}
    head = f"log_assignment.{n_layers - 1}."
    keep = {}
    for k, v in sd.items():
        if k.startswith(head):
            keep[k[len(head):]] = v
        elif k.startswith(("input_proj.", "posenc.")) or (
                k.startswith("transformers.")
                and int(k.split(".")[1]) < n_layers):
            keep[k] = v
    keep = {k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in keep.items()}
    for want in ("input_proj.weight", "posenc.Wr.weight", "final_proj.weight",
                 "matchability.weight"):
        if want not in keep:
            raise KeyError(f"missing {want} in checkpoint")
    return {"params": _params.state_dict_to_tree(keep)}


def save_weights(net: LightGlueNet, path) -> None:
    """Write `net`'s parameters and meta [dim, n_layers, heads] (the
    reference's lightglue_d{D}.npz layout)."""
    _params.write_npz(path, _params.module_tree(net), meta=np.asarray(
        [net.dim, len(net.transformers), net.heads], np.int32))


def convert_torch_checkpoint(path_in, path_out=None, heads: int = 4) -> Dict:
    """cvg/LightGlue .pth -> lightglue_d{D}.npz and lightglue.npz in the
    weights directory (or `path_out`); dim and depth come from the state
    dict, the head count (not visible in the shapes) from `heads`."""
    from tpu3drec_torch import models
    sd = torch.load(path_in, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {(k[8:] if k.startswith("matcher.") else k): v.numpy()
          for k, v in sd.items()}
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("transformers."))
    dim, in_dim = sd["input_proj.weight"].shape
    params = load_torch_weights(sd, n_layers=n_layers)
    meta = np.asarray([dim, n_layers, heads], np.int32)
    outs = [path_out] if path_out else [
        Path(models.WEIGHTS_DIR) / f"lightglue_d{in_dim}.npz",
        Path(models.WEIGHTS_DIR) / "lightglue.npz"]
    for out in outs:
        _params.write_npz(out, params["params"], meta=meta)
    return params


_LG_CACHE: Dict[int, LightGlue] = {}


def match_features_lightglue(feats0: Features, feats1: Features,
                             filter_threshold: float = 0.1) -> Matches:
    """The registry's LightGlue matcher: the converted weights for the
    descriptors' dimension, or ImportError (the caller falls back to kNN
    and records it)."""
    from tpu3drec_torch import models
    input_dim = feats0.desc.shape[-1]
    if input_dim not in _LG_CACHE:
        lg = None
        for name in (f"lightglue_d{input_dim}.npz", "lightglue.npz"):
            path = Path(models.WEIGHTS_DIR) / name
            if not path.exists():
                continue
            tree, extras = _params.read_npz(path)
            if np.asarray(tree["input_proj"]["kernel"]).shape[0] != input_dim:
                continue          # converted for another extractor's dim
            dim, n_layers, heads = ((int(v) for v in extras["meta"][:3])
                                    if "meta" in extras else (256, 9, 4))
            net = _params.load_tree(LightGlueNet(input_dim, dim, n_layers,
                                                 heads), tree)
            lg = LightGlue(net.eval().requires_grad_(False))
            break
        if lg is None:
            raise ImportError("lightglue weights not available for "
                              f"{input_dim}-d descriptors")
        _LG_CACHE[input_dim] = lg
    lg = _LG_CACHE[input_dim]
    lg.net.to(feats0.desc.device)
    return lg.match(feats0, feats1, filter_threshold)
