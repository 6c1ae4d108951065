"""Seeded weights, drawn on the card under the program's parameter names.

Two draws from one ``torch.Generator`` on the device (uniforms for every
parameter, normals for the embedding tables), cut into views and scaled
by what each parameter is:

- a linear or convolution weight: U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
  ``fan_in`` the product of its shape after the first axis (the init of
  the model's layers; for a transposed conv that is out x kernel);
- a bias: the same bound as its weight;
- a norm's weight 1 + U(-0.1, 0.1), its bias U(-0.1, 0.1);
- a LayerScale: U(0.05, 0.15), so that the DConv and transformer branches
  carry weight in the output the check compares (trained demucs scales
  are of this order; the 1e-3 / 1e-4 inits would hide them);
- an embedding table: N(0, 1); the frequency embedding N(0, 0.1) (its
  init is a cumulative sum scaled down by 10).

Float32, the masters the program holds.  The same seed gives the same
weights on the same device type.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import torch


def _kind(name: str, shape: Sequence[int]) -> str:
    parts = name.split(".")
    leaf, owner = parts[-1], parts[-2]
    if leaf == "scale":
        return "layer_scale"
    if len(shape) == 2 and "embedding" in name:
        return "embedding"
    # a DConv block's GroupNorms sit at indices 1 and 4 of its Sequential
    dconv_norm = ".dconv.layers." in name and owner in ("1", "4")
    if len(shape) == 1 and ("norm" in owner.lower() or dconv_norm):
        return "norm_" + leaf
    return "bias" if len(shape) == 1 else "weight"


def make(shapes: Mapping[str, Sequence[int]], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` on ``device`` for every entry of
    ``shapes`` (name -> shape, in the program's ``state_dict`` order)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    names = list(shapes)
    kinds = {n: _kind(n, shapes[n]) for n in names}
    sizes = {n: math.prod(shapes[n]) for n in names}
    uni = torch.rand(sum(sizes[n] for n in names if kinds[n] != "embedding"),
                     generator=gen, device=device)
    nrm = torch.randn(sum(sizes[n] for n in names if kinds[n] == "embedding"),
                      generator=gen, device=device)
    fan_in = {n.rsplit(".", 1)[0]: math.prod(shapes[n][1:]) for n in names
              if kinds[n] == "weight"}
    out, iu, iz = {}, 0, 0
    for n in names:
        k, size, shape = kinds[n], sizes[n], tuple(shapes[n])
        if k == "embedding":
            t = nrm[iz:iz + size].view(shape)
            iz += size
            if "freq_emb" in n:
                t.mul_(0.1)
            out[n] = t
            continue
        u = uni[iu:iu + size].view(shape)
        iu += size
        if k == "layer_scale":
            out[n] = u.mul_(0.1).add_(0.05)
        elif k == "norm_weight":
            out[n] = u.mul_(0.2).add_(0.9)
        elif k in ("norm_bias",):
            out[n] = u.mul_(0.2).sub_(0.1)
        else:
            owner = n.rsplit(".", 1)[0]
            if k == "bias" and n.endswith("in_proj_bias"):
                owner = n[: -len("_bias")] + "_weight"
                fan = shapes[owner][1]
            elif k == "bias":
                fan = fan_in.get(owner, shape[0])
            else:
                fan = math.prod(shape[1:])
            b = 1.0 / math.sqrt(fan)
            out[n] = u.mul_(2 * b).sub_(b)
    return out
