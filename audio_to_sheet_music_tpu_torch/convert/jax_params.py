"""JAX param pytree / ``.npz`` -> ``state_dict`` for the port's modules.

The JAX package stores every weight in its torch layout, so the bridge is a
pure renaming with no transposes.  The names are the ones the JAX package's
``convert/torch_import.export_torch_names`` produces; this module keeps its
own copy of that path-to-name translation (``tree_paths`` / ``translate``)
so the port never imports the JAX package.

Two sources:

- an in-memory param pytree (nested dicts/lists) whose leaves are numpy
  arrays — what ``jax.tree.map(np.asarray, params)`` gives;
- an ``.npz`` written by the JAX ``train/checkpoint.save_params_npz``: one
  array per leaf, keyed by the ``/``-joined pytree path (e.g. the committed
  ``artifacts/trained_head.npz`` with keys ``freq_decoder/layers/0/conv/bias``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

# demucs DConv block: Sequential(conv1, norm1, GELU, conv2, norm2, GLU, scale)
_DCONV_SEQ = {"conv1": "0", "norm1": "1", "conv2": "3", "norm2": "4", "scale": "6"}


def translate(parts: Sequence[str]) -> str:
    """Map a pytree path (list of keys/indices) to the torch dotted name."""
    out: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in _DCONV_SEQ and i >= 2 and parts[i - 2] == "layers" and "dconv" in out:
            out.append(_DCONV_SEQ[p])
            if p == "scale":
                out.append("scale")  # LayerScale's param is itself named scale
                i += 2  # skip the inner "scale" leaf name
                continue
        elif p == "scale" and out and out[-1] in ("gamma_1", "gamma_2"):
            out.append("scale")
        elif p == "conv" and i >= 2 and parts[0] in ("freq_decoder", "time_decoder"):
            out.append("0")          # head decoder Sequential index
        elif p == "norm" and i >= 2 and parts[0] in ("freq_decoder", "time_decoder"):
            out.append("1")
        else:
            out.append(p)
        i += 1
    return ".".join(out)


def tree_paths(tree: Any, prefix: List[str] | None = None
               ) -> Iterator[Tuple[List[str], Any]]:
    """Yield ``(path, leaf)`` for every leaf of a nested dict/list tree."""
    prefix = prefix or []
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, prefix + [str(k)])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + [str(i)])
    else:
        yield prefix, tree


def state_dict_from_params(params: Any, prefix: Sequence[str] = ()
                           ) -> Dict[str, torch.Tensor]:
    """Param pytree with array leaves -> ``{torch name: f32 tensor}``.

    ``prefix`` is the pytree path of ``params`` inside the full model tree
    (e.g. ``("head",)``): the translation rules look at the full path.
    """
    return {translate(list(prefix) + p): torch.from_numpy(
                np.array(leaf, dtype=np.float32))
            for p, leaf in tree_paths(params)}


def state_dict_from_npz(path: str | Path, prefix: Sequence[str] = ()
                        ) -> Dict[str, torch.Tensor]:
    """``save_params_npz`` file -> ``{torch name: f32 tensor}``.

    ``prefix`` is where the saved tree sits in the full model tree: the
    committed trained head was saved from ``params["head"]``, so it loads
    with ``prefix=("head",)``.
    """
    with np.load(path) as data:
        return {translate(list(prefix) + k.split("/")): torch.from_numpy(
                    np.array(data[k], dtype=np.float32))
                for k in data.files}


def load_npz(module: torch.nn.Module, path: str | Path,
             prefix: Sequence[str] = ()) -> torch.nn.Module:
    """Load a ``save_params_npz`` file of the tree at ``prefix`` into
    ``module`` (the module that holds that subtree), strictly."""
    state = state_dict_from_npz(path, prefix=prefix)
    cut = len(".".join(prefix)) + 1 if prefix else 0
    module.load_state_dict({k[cut:]: v for k, v in state.items()}, strict=True)
    return module
