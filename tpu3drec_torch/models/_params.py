"""Converted checkpoints: the JAX package's npz layout, and its flax
parameter trees carried into the port's `state_dict`s and back.

The npz layout is what `tpu3drec/models/*:convert_torch_checkpoint`
write:

- `params`: a 0-d object array holding the flax tree as numpy arrays.
  superpoint.npz and the approximate aliked.npz wrap it as
  `{"params": tree}`; the others store the tree itself.
- `meta = [dim, n_layers, heads]` for LightGlue.
- `format = ["aliked-n16"]` for the published ALIKED network.

A tree leaf and its `state_dict` entry:

- `name_<i>` <-> `name.<i>` (flax's numbered submodules, a `ModuleList`
  or `Sequential` index here);
- `kernel`, 4-d HWIO <-> `weight`, OIHW (convolutions);
- `kernel`, 2-d (in, out) <-> `weight`, (out, in) (dense layers);
- `scale` <-> `weight` (LayerNorm, BatchNorm);
- `mean` / `var` <-> `running_mean` / `running_var` (BatchNorm);
- any other leaf (`bias`, DISK's `prelu`, SDDH's `agg`) as it is.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

_NUMBERED = re.compile(r"_(\d+)$")


def read_npz(path) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(the flax tree, unwrapped; the other arrays of the file)."""
    with np.load(path, allow_pickle=True) as data:
        tree = data["params"].item()
        extras = {k: data[k] for k in data.files if k != "params"}
    if set(tree) == {"params"}:
        tree = tree["params"]
    return tree, extras


def write_npz(path, tree: Dict[str, Any], wrap: bool = False,
              **extras) -> None:
    """Write `tree` as the JAX converters do (`wrap`: as {"params": tree})."""
    tree = {"params": tree} if wrap else tree
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, params=np.asarray(tree, dtype=object), **extras)


def _leaf_to_torch(name: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        return "weight", (a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
    return {"scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(name, name), a


def tree_to_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax tree (numpy or jax leaves) -> a float32 `state_dict`."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + [_NUMBERED.sub(r".\1", k)])
            else:
                name, a = _leaf_to_torch(k, np.asarray(v, np.float32))
                out[".".join(prefix + [name])] = torch.tensor(a)
    walk(tree, [])
    return out


def state_dict_to_tree(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A `state_dict` -> the flax tree (float32 numpy leaves)."""
    tree: Dict[str, Any] = {}
    for key, t in sd.items():
        parts = key.split(".")
        leaf = parts.pop()
        if leaf == "num_batches_tracked":
            continue
        path = []
        for p in parts:          # "transformers", "0" -> "transformers_0"
            if p.isdigit():
                path[-1] = f"{path[-1]}_{p}"
            else:
                path.append(p)
        a = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            leaf, a = (("kernel", a.transpose(2, 3, 1, 0)) if a.ndim == 4
                       else ("kernel", a.T) if a.ndim == 2 else ("scale", a))
        else:
            leaf = {"running_mean": "mean", "running_var": "var"}.get(
                leaf, leaf)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def load_tree(module: torch.nn.Module, tree: Dict[str, Any]) -> torch.nn.Module:
    """Give `module` the parameters of a flax tree (strict: every entry
    of its `state_dict` but BatchNorm's step counters, and nothing else)."""
    sd = tree_to_state_dict(tree)
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    module.load_state_dict(sd, strict=True)
    return module


def module_tree(module: torch.nn.Module) -> Dict[str, Any]:
    """The flax tree of `module`'s parameters."""
    return state_dict_to_tree(module.state_dict())


def init_random(module: torch.nn.Module,
                generator: torch.Generator) -> torch.nn.Module:
    """flax's default initialisers, drawn from `generator`: convolution
    and dense weights lecun-normal (a normal truncated at two deviations,
    scaled to variance 1 / fan-in), biases 0, norm scales 1. Other
    parameters keep the value the module gave them."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and p.ndim >= 2:
                std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
                torch.nn.init.trunc_normal_(p, std=std, a=-2 * std,
                                            b=2 * std, generator=generator)
            elif leaf == "bias":
                p.zero_()
            elif leaf == "weight":
                p.fill_(1.0)
    return module


_MODULES: Dict[tuple, torch.nn.Module] = {}


def cached_module(path: Path, build: Callable, device) -> torch.nn.Module:
    """`build(tree, extras)` of the npz at `path`, on `device`, in eval
    mode; built once per file version and device (a rewritten file
    replaces the module built from its older version)."""
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size, str(device))
    mod = _MODULES.get(key)
    if mod is None:
        for old in [k for k in _MODULES if (k[0], k[3]) == (key[0], key[3])]:
            del _MODULES[old]
        mod = build(*read_npz(path)).to(device).eval().requires_grad_(False)
        _MODULES[key] = mod
    return mod
