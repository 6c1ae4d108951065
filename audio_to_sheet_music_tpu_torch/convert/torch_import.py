"""Reference ``.pt`` checkpoints <-> the port's modules.

Counterpart of ``audio_to_sheet_music_tpu/convert/torch_import.py``.  The
port's modules already hold their weights under torch names and layouts
(``convert/jax_params.py``), so a reference checkpoint loads by prefix
handling and ``load_state_dict``.  Three checkpoint families:

- the demucs pretrained ``htdemucs`` tower (``import_htdemucs_state``);
- the HF CLAP towers of ``laion/clap-htsat-unfused``: the text side
  (``import_clap_state``, ``text_model.`` prefixes) and the audio side
  (``import_clap_audio_state``, ``audio_model.audio_encoder.`` prefix,
  BatchNorm's ``num_batches_tracked`` skipped);
- the reference's own training checkpoints ``{epoch, model_state_dict,
  optimizer_state_dict, ...}`` of the whole ``AudioTextHTDemucs``, keyed
  ``htdemucs.*`` / ``clap.*`` / bare head names, optionally behind a
  ``module.`` DataParallel prefix (``import_atht_checkpoint`` and its
  inverse ``export_atht_checkpoint``).

``REFERENCE_PREFIXES`` and ``DECODER_SEQ`` are the one table of names that
differ between the port and the reference; both directions read it.  As in
the JAX package, ``strict`` only refuses *missing* names: a checkpoint's
extra entries (HF's ``position_ids`` buffers, a full ``ClapModel``'s audio
side) are ignored.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping

import torch
from torch import nn

from ..nn import prng

__all__ = [
    "load_torch_state_dict",
    "to_reference_name",
    "from_reference_name",
    "load_into",
    "import_htdemucs_state",
    "import_clap_state",
    "import_clap_audio_state",
    "import_atht_checkpoint",
    "export_atht_checkpoint",
]

# (port prefix, reference prefix), the head's catch-all last
REFERENCE_PREFIXES = (
    ("htdemucs.", "htdemucs."),
    ("clap.embeddings.", "clap.text_model.embeddings."),
    ("clap.layer.", "clap.text_model.encoder.layer."),
    ("clap.pooler.", "clap.text_model.pooler."),
    ("clap.text_projection.", "clap.text_projection."),
    ("head.", ""),
)
# a head decoder layer is an nn.Sequential(ConvTranspose, GroupNorm, GELU)
# in the reference: port child name -> its Sequential index
DECODER_SEQ = {"conv": "0", "norm": "1"}
_DECODER = r"^((?:freq|time)_decoder\.layers\.\d+)\.({})\."
_TO_REF = re.compile(_DECODER.format("|".join(DECODER_SEQ)))
_FROM_REF = re.compile(_DECODER.format("|".join(DECODER_SEQ.values())))
_SEQ_NAME = {v: k for k, v in DECODER_SEQ.items()}
HF_AUDIO_PREFIX = "audio_model.audio_encoder."


def load_torch_state_dict(path: str | Path) -> Dict[str, torch.Tensor]:
    """Read a ``.pt`` checkpoint into ``{name: tensor}`` on the CPU.

    Unwraps the reference's ``model_state_dict`` container and demucs's
    ``state`` container, and strips a ``module.`` DataParallel prefix."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and isinstance(obj.get("state"), dict):
        obj = obj["state"]
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            out[k] = v.detach()
    return out


def to_reference_name(name: str) -> str:
    """A port ``AudioTextHTDemucs`` state-dict name -> the reference's."""
    for port, ref in REFERENCE_PREFIXES:
        if name.startswith(port):
            rest = name[len(port):]
            if port == "head.":
                rest = _TO_REF.sub(lambda m: f"{m[1]}.{DECODER_SEQ[m[2]]}.",
                                   rest)
            return ref + rest
    raise KeyError(f"{name}: not a name of AudioTextHTDemucs")


def from_reference_name(name: str) -> str:
    """A reference checkpoint name -> the port's (inverse of
    ``to_reference_name``; a name outside ``htdemucs.`` / ``clap.`` is the
    head's)."""
    for port, ref in REFERENCE_PREFIXES:
        if ref and name.startswith(ref):
            return port + name[len(ref):]
    if name.startswith("clap."):
        return name                  # a CLAP entry the port has no copy of
    return "head." + _FROM_REF.sub(lambda m: f"{m[1]}.{_SEQ_NAME[m[2]]}.",
                                   name)


def load_into(module: nn.Module, state: Mapping[str, torch.Tensor],
              strict: bool = True, what: str = "") -> nn.Module:
    """``state`` into ``module`` in place; every name ``module`` has must be
    there when ``strict`` (a missing one keeps its value otherwise), and
    names ``module`` does not have are ignored.  Shapes must match."""
    own = module.state_dict()
    missing = [k for k in own if k not in state]
    if strict and missing:
        raise KeyError(f"{what or type(module).__name__}: {len(missing)} "
                       f"params missing, e.g. {missing[:5]}")
    module.load_state_dict({k: v for k, v in state.items() if k in own},
                           strict=False)
    return module


def _clap_key(name: str) -> str:
    """An HF CLAP text name (``text_model.*``, ``text_projection.*``) ->
    the port's ``ClapText`` name, through ``REFERENCE_PREFIXES``."""
    return from_reference_name("clap." + name)[len("clap."):]


def import_htdemucs_state(state: Mapping[str, torch.Tensor], prefix: str = "",
                          strict: bool = True, model=None):
    """demucs ``HTDemucs`` state dict -> ``models.htdemucs.HTDemucs``
    (``model``, or the full-width seeded init)."""
    from ..models import htdemucs

    model = model if model is not None else htdemucs.HTDemucs(
        key=prng.PRNGKey(0))
    sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    return load_into(model, sub, strict, "htdemucs")


def import_clap_state(state: Mapping[str, torch.Tensor], prefix: str = "",
                      strict: bool = True, model=None):
    """HF ``ClapModel`` / ``ClapTextModelWithProjection`` state dict ->
    ``models.clap_text.ClapText``."""
    from ..models import clap_text

    model = model if model is not None else clap_text.ClapText(
        key=prng.PRNGKey(0))
    sub = {_clap_key(k[len(prefix):]): v for k, v in state.items()
           if k.startswith(prefix)}
    return load_into(model, sub, strict, "clap")


def import_clap_audio_state(state: Mapping[str, torch.Tensor],
                            strict: bool = True, model=None):
    """HF ``ClapAudioModel(WithProjection)`` / ``ClapModel`` audio side ->
    ``models.clap_audio.ClapAudio``."""
    from ..models import clap_audio

    model = model if model is not None else clap_audio.ClapAudio(
        key=prng.PRNGKey(0))
    sub = {k.replace(HF_AUDIO_PREFIX, ""): v for k, v in state.items()
           if not k.endswith("num_batches_tracked")}
    return load_into(model, sub, strict, "clap_audio")


def import_atht_checkpoint(path: str | Path, strict: bool = True,
                           model=None):
    """Reference ``AudioTextHTDemucs`` ``.pt`` -> the port's model.

    Loads into ``model`` (default: the full-width seeded init, so CLAP
    names the checkpoint lacks keep a defined value): ``htdemucs.*`` and
    the head under ``strict``, ``clap.*`` never strictly (the reference
    loads with ``strict=False`` to tolerate CLAP-variant drift)."""
    from ..models import atht

    state = load_torch_state_dict(path)
    model = model if model is not None else atht.init(0)
    parts: Dict[str, Dict[str, torch.Tensor]] = {
        "htdemucs": {}, "clap": {}, "head": {}}
    for k, v in state.items():
        name = from_reference_name(k)
        top, _, rest = name.partition(".")
        parts[top][rest] = v
    load_into(model.htdemucs, parts["htdemucs"], strict, "htdemucs")
    if parts["clap"]:
        load_into(model.clap, parts["clap"], False, "clap")
    load_into(model.head, parts["head"], strict, "head")
    return model


def export_atht_checkpoint(model, path: str | Path, epoch: int = 0,
                           metrics: Mapping[str, float] | None = None) -> None:
    """The port's model -> a reference-style ``.pt`` training checkpoint
    ``{epoch, model_state_dict, metrics}`` under the reference's names,
    with the ``position_ids`` / ``token_type_ids`` buffers that HF registers
    (a reference-side strict ``load_state_dict`` asks for them)."""
    state: Dict[str, Any] = {to_reference_name(k): v.detach().cpu()
                             for k, v in model.state_dict().items()}
    n_pos = state["clap.text_model.embeddings.position_embeddings.weight"
                  ].shape[0]
    state["clap.text_model.embeddings.position_ids"] = torch.arange(
        n_pos, dtype=torch.int64)[None]
    state["clap.text_model.embeddings.token_type_ids"] = torch.zeros(
        (1, n_pos), dtype=torch.int64)
    torch.save({"epoch": int(epoch), "model_state_dict": state,
                "metrics": dict(metrics or {})}, path)
