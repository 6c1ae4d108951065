"""Reference ``.pt`` checkpoints in the port against the JAX package (CPU).

- A ``.pt`` the JAX ``export_atht_checkpoint`` writes from seeded
  ``atht.init_tiny`` params, imported by both packages: every weight equal,
  the layers within 1e-5 of their peak and ``separate_all_pcm`` within one
  int16 step.
- The port's ``export_atht_checkpoint``, read by the JAX
  ``load_torch_state_dict``: the JAX export's keys, bitwise-equal arrays.
- The tower importers on reference names: demucs names into
  ``import_htdemucs_state``, HF CLAP text names (from the JAX export, and
  from a ``transformers`` model where it imports) into
  ``import_clap_state``, strictly.
- The containers (``module.`` prefix, ``{"state": ...}``), ``strict`` on a
  missing head key, and ``atht.load_params`` on ``.pt`` / ``.npz`` / a
  trainer directory.
- ``train(resume_from=*.pt)`` at tiny width against the JAX ``train`` on the
  same file: the first step's loss within 1e-5 relative (the train-step
  tolerance of ``tests/test_torch_train.py``), the second within 1e-5 of
  the run's largest loss.
- The port's byte-level BPE gives the ids of the ``tokenizers`` library
  (through the JAX ``RobertaBpeTokenizer``).
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_to_sheet_music_tpu.config import Config as JConfig
from audio_to_sheet_music_tpu.convert import torch_import as JTI
from audio_to_sheet_music_tpu.data import synthetic_tracks
from audio_to_sheet_music_tpu.infer import Separator as JaxSeparator
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.text import tokenizer as JT
from audio_to_sheet_music_tpu.text.prompts import STEM_PROMPTS
from audio_to_sheet_music_tpu.train import trainer as JTR
from audio_to_sheet_music_tpu_torch import config as TC
from audio_to_sheet_music_tpu_torch.convert import jax_params
from audio_to_sheet_music_tpu_torch.convert import torch_import as TTI
from audio_to_sheet_music_tpu_torch.infer.session import Separator
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.text import tokenizer as TT
from audio_to_sheet_music_tpu_torch.train import checkpoint as TCK

STEMS = ("drums", "bass", "other", "vocals")
KW = dict(segment_seconds=0.25, overlap_seconds=0.05)
PROMPTS = [p for ps in STEM_PROMPTS.values() for p in ps]


@pytest.fixture(scope="module")
def jax_pt(tmp_path_factory):
    """The JAX export of seeded ``init_tiny`` params, and those params."""
    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))
    path = tmp_path_factory.mktemp("jax_pt") / "tiny.pt"
    JTI.export_atht_checkpoint(params, str(path), epoch=3,
                               metrics={"val_sdr": 1.5})
    return path, params


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return TT.write_bpe_vocab(PROMPTS, tmp_path_factory.mktemp("vocab"))


def _tiny_from_pt(path) -> TA.AudioTextHTDemucs:
    return TTI.import_atht_checkpoint(path, strict=True,
                                      model=TA.init_tiny(materialize=False))


def test_jax_export_imports_into_every_weight(jax_pt):
    path, params = jax_pt
    model = _tiny_from_pt(path)
    want = jax_params.state_dict_from_params(params)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    # the JAX import of the same file holds the same arrays
    jp = JTI.import_atht_checkpoint(str(path), strict=True,
                                    template=JA.init_tiny(jax.random.PRNGKey(1)))
    for k, v in jax_params.state_dict_from_params(
            jax.tree.map(np.asarray, jp)).items():
        assert torch.equal(v, got[k]), k


def test_imported_models_separate_as_jax(jax_pt):
    """The layers of the two imports (text embedding, the encoder's two
    outputs) within 1e-5 of their peak; the PCM of every stem within one
    int16 step."""
    path, _ = jax_pt
    song = (0.3 * np.random.default_rng(0).standard_normal((2, 44100))
            ).astype(np.float32)
    jp = JTI.import_atht_checkpoint(str(path), strict=True,
                                    template=JA.init_tiny(jax.random.PRNGKey(1)))
    model = _tiny_from_pt(path)
    ids = np.array([[0, 9, 11, 13, 2]], np.int32)
    mask = np.ones_like(ids)
    wav = song[None, :, :11025]
    with torch.no_grad():
        layers = [(TA.encode_text(model, torch.from_numpy(ids),
                                  torch.from_numpy(mask)),
                   JA.encode_text(jp, jnp.asarray(ids), jnp.asarray(mask)))]
        enc = TA.encode_mixture(model, torch.from_numpy(wav))
    jenc = jax.jit(lambda p, w: {k: v for k, v in JA.encode_mixture(
        p, w).items() if k in ("x_enc", "xt_enc")})(jp, jnp.asarray(wav))
    layers += [(enc[k], jenc[k]) for k in ("x_enc", "xt_enc")]
    for got, want in layers:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    port = Separator(model, device="cpu", **KW)
    pcm, scales = port.separate_all_pcm(song, stems=STEMS)
    jpcm, jscales = JaxSeparator(jp, compute_dtype=jnp.float32,
                                 **KW).separate_all_pcm(song, stems=STEMS)
    np.testing.assert_allclose(scales, jscales, rtol=1e-6)
    assert np.abs(pcm.astype(np.int32) - jpcm.astype(np.int32)).max() <= 1
    assert np.abs(pcm).max() > 100


def test_port_export_reads_in_jax_bitwise(jax_pt, tmp_path):
    path, _ = jax_pt
    want = JTI.load_torch_state_dict(str(path))
    ours = tmp_path / "port.pt"
    TTI.export_atht_checkpoint(_tiny_from_pt(path), ours, epoch=3,
                               metrics={"val_sdr": 1.5})
    got = JTI.load_torch_state_dict(str(ours))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k
    saved = torch.load(ours, weights_only=False)
    assert saved["epoch"] == 3 and saved["metrics"] == {"val_sdr": 1.5}


def test_names_round_trip(jax_pt):
    names = TA.init_tiny(materialize=False).state_dict().keys()
    ref = {TTI.to_reference_name(k) for k in names}
    assert {"freq_decoder.layers.0.0.weight", "time_decoder.layers.2.1.bias",
            "clap.text_model.encoder.layer.1.output.dense.weight",
            "htdemucs.encoder.0.conv.weight"} <= ref
    for k in names:
        assert TTI.from_reference_name(TTI.to_reference_name(k)) == k


# a name each tower's importer must find, under the reference's names
NEEDED = {"htdemucs": "encoder.0.conv.weight",
          "clap": "text_model.encoder.layer.0.output.dense.weight"}


@pytest.mark.parametrize("tower,prefix", [("htdemucs", ""),
                                          ("htdemucs", "model."),
                                          ("clap", ""), ("clap", "clap.")])
def test_tower_importers_take_reference_names(jax_pt, tower, prefix):
    """demucs names (the JAX ``export_torch_names`` of the tower) into
    ``import_htdemucs_state``, and HF ``ClapTextModelWithProjection`` names
    (the JAX export's ``clap.*`` entries, ``clap.`` taken off, with HF's
    buffers) into ``import_clap_state``, each behind ``prefix`` and under
    ``strict``: every tensor equal; a missing name raises."""
    path, params = jax_pt
    if tower == "htdemucs":
        names = JTI.export_torch_names(params["htdemucs"])
        load = TTI.import_htdemucs_state
    else:
        names = {k[len("clap."):]: v for k, v in
                 JTI.load_torch_state_dict(str(path)).items()
                 if k.startswith("clap.")}
        assert "text_model.embeddings.position_ids" in names
        load = TTI.import_clap_state
    state = {prefix + k: torch.from_numpy(np.array(v))
             for k, v in names.items()}
    model = load(state, prefix=prefix, strict=True,
                 model=getattr(TA.init_tiny(materialize=False), tower))
    want = jax_params.state_dict_from_params(params)
    got = model.state_dict()
    assert len(got) > 20
    for k, v in got.items():
        assert torch.equal(v, want[f"{tower}.{k}"]), k
    del state[prefix + NEEDED[tower]]
    with pytest.raises(KeyError, match="missing"):
        load(state, prefix=prefix, strict=True,
             model=getattr(TA.init_tiny(materialize=False), tower))


def test_clap_importer_takes_a_transformers_model():
    """An HF ``ClapTextModelWithProjection`` (2 layers, width 128, seeded
    random weights) through ``import_clap_state`` strictly: the port's
    ``text_embeds`` within 1e-5 of the peak of HF's."""
    transformers = pytest.importorskip("transformers")
    from audio_to_sheet_music_tpu_torch.models import clap_text

    torch.manual_seed(0)
    hf = transformers.ClapTextModelWithProjection(transformers.ClapTextConfig(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=512)).eval()
    model = TTI.import_clap_state(hf.state_dict(), strict=True,
                                  model=clap_text.ClapText(num_layers=2,
                                                           hidden=128))
    ids = torch.tensor([[0, 5234, 1000, 2, 1, 1], [0, 999, 2, 1, 1, 1]])
    mask = (ids != 1).long()
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).text_embeds
        got = clap_text.text_embeds(model, ids, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("container", ["module", "state"])
def test_containers_load(jax_pt, tmp_path, container):
    path, params = jax_pt
    state = torch.load(path, weights_only=False)["model_state_dict"]
    if container == "module":
        obj = {"model_state_dict": {"module." + k: v for k, v in state.items()}}
    else:
        obj = {"state": state}
    torch.save(obj, tmp_path / "c.pt")
    model = _tiny_from_pt(tmp_path / "c.pt")
    want = jax_params.state_dict_from_params(params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_strict_refuses_a_missing_head_key(jax_pt, tmp_path):
    path, _ = jax_pt
    obj = torch.load(path, weights_only=False)
    del obj["model_state_dict"]["freq_decoder.layers.0.0.weight"]
    torch.save(obj, tmp_path / "cut.pt")
    with pytest.raises(KeyError, match="head"):
        _tiny_from_pt(tmp_path / "cut.pt")
    with pytest.raises(KeyError, match="missing"):
        JTI.import_atht_checkpoint(str(tmp_path / "cut.pt"), strict=True,
                                   template=JA.init_tiny(
                                       jax.random.PRNGKey(0)))
    before = TA.init_tiny(5)
    kept = before.head.freq_decoder.layers[0].conv.weight.clone()
    TTI.import_atht_checkpoint(tmp_path / "cut.pt", strict=False,
                               model=before)
    assert torch.equal(before.head.freq_decoder.layers[0].conv.weight, kept)


def test_load_params_takes_three_forms(jax_pt, tmp_path, monkeypatch, vocab):
    path, params = jax_pt
    want = jax_params.state_dict_from_params(params)
    model = TA.load_params(TA.init_tiny(7), path)
    assert model.pretrained
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    monkeypatch.delenv("ATSM_TOKENIZER_DIR", raising=False)
    with pytest.raises(RuntimeError, match="vocabulary"):
        Separator(model, device="cpu", **KW)
    monkeypatch.setenv("ATSM_TOKENIZER_DIR", str(vocab))
    assert isinstance(Separator(model, device="cpu", **KW).tokenizer,
                      TT.RobertaBpeTokenizer)

    npz = tmp_path / "all.npz"
    np.savez(npz, **{"/".join(p): leaf for p, leaf in
                     jax_params.tree_paths(params)})
    model = TA.load_params(TA.init_tiny(8), npz)
    assert not model.pretrained
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())

    ckpt_dir = tmp_path / "run" / "latest"
    ckpt_dir.mkdir(parents=True)
    head = TA.init_tiny(9).head.state_dict()
    torch.save({"head": head, "optimizer": {}, "step": 0},
               ckpt_dir / TCK.STATE_FILE)
    model = TA.load_params(TA.init_tiny(10), ckpt_dir)
    assert all(torch.equal(v, head[k])
               for k, v in model.head.state_dict().items())
    with pytest.raises(ValueError, match="unsupported"):
        TA.load_params(TA.init_tiny(10), tmp_path / "x.safetensors")


def test_byte_level_bpe_matches_the_tokenizers_library(vocab):
    pytest.importorskip("tokenizers")
    texts = PROMPTS + ["Hello world's  drums_and 123 bass!! ", "",
                       "  ünïcode ☃ 12ab", "a\n\tb  c"]
    jids, jmask = JT.RobertaBpeTokenizer(vocab)(texts)
    tids, tmask = TT.RobertaBpeTokenizer(vocab)(texts)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tmask, jmask)
    assert (tids[:len(PROMPTS), 2] == TT.EOS).sum() > 0   # one-id words


def test_train_resume_from_pt_matches_jax(jax_pt, tmp_path, monkeypatch,
                                          vocab):
    """Both trainers convert the same ``.pt`` (as pretrained: the BPE files
    are required) and take two steps on the same batches."""
    from audio_to_sheet_music_tpu_torch.train.trainer import train

    path, _ = jax_pt
    monkeypatch.setenv("ATSM_TOKENIZER_DIR", str(vocab))
    monkeypatch.setattr(JA, "init", JA.init_tiny)
    monkeypatch.setattr(TA, "init",
                        lambda seed=0, **kw: TA.init_tiny(seed, **kw))
    data = tmp_path / "data"
    synthetic_tracks(2, seconds=1.0, cache_dir=data)
    raw = {"data": {"train_dir": str(data), "test_dir": str(data),
                    "segment_seconds": 0.25},
           "model": {"compute_dtype": "float32"},
           "training": {"batch_size": 2, "num_epochs": 1,
                        "resume_from": str(path)},
           "wandb": {"use_wandb": False, "log_every": 1, "validate_every": 5}}
    logs = {}
    for name, conf, run in (
            ("jax", JConfig, lambda c: JTR.train(c, max_steps_per_epoch=2)),
            ("port", TC.Config, lambda c: train(c, max_steps_per_epoch=2,
                                                 device="cpu"))):
        cfg = conf.from_dict(raw)
        cfg = dataclasses.replace(cfg, wandb=dataclasses.replace(
            cfg.wandb, checkpoint_dir=str(tmp_path / name / "ckpt"),
            output_dir=str(tmp_path / name / "out")))
        run(cfg)
        lines = (tmp_path / name / "out" / "metrics.jsonl").read_text()
        logs[name] = [r["train/loss/total"] for r in map(
            json.loads, lines.splitlines()) if "train/loss/total" in r]
    assert len(logs["port"]) == len(logs["jax"]) == 2
    # the first step's loss is the import's alone: 1e-5 relative.  The
    # second comes after one AdamW step, which moves an element whose
    # gradient nearly cancels by O(lr) on last-bit differences
    # (tests/test_torch_train.py): 1e-5 of the run's largest loss
    np.testing.assert_allclose(logs["port"][0], logs["jax"][0], rtol=1e-5)
    np.testing.assert_allclose(logs["port"], logs["jax"], rtol=0,
                               atol=1e-5 * max(map(abs, logs["jax"])))
