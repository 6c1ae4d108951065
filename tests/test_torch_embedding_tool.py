"""The prompt-embedding tool and Word2Vec in the port against the JAX
package (CPU).

- ``Word2Vec.train`` gives the JAX vectors exactly for the same seed, and
  ``embed_texts`` the same embeddings, kept texts and indices.
- ``analyze_clustering`` equals JAX on the same embeddings.
- ``embed_prompts`` through the shared loader on a reference ``.pt`` (the
  JAX export of seeded ``init_tiny`` params; converted weights need the
  BPE files) within 1e-5 of the JAX tool's embeddings.
- ``main`` on the CPU writes the report and the figures.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from audio_to_sheet_music_tpu.apps import embedding_tool as JE
from audio_to_sheet_music_tpu.convert import torch_import as JTI
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu.text import word2vec as JW
from audio_to_sheet_music_tpu_torch.apps import embedding_tool as TE
from audio_to_sheet_music_tpu_torch.text import word2vec as TW
from audio_to_sheet_music_tpu_torch.text.tokenizer import write_bpe_vocab


def test_word2vec_equals_jax():
    got = TW.Word2Vec.train(TW.MUSIC_CORPUS, dim=16, epochs=60, seed=3)
    want = JW.Word2Vec.train(JW.MUSIC_CORPUS, dim=16, epochs=60, seed=3)
    assert got.vectors.keys() == want.vectors.keys()
    for w, v in got.vectors.items():
        np.testing.assert_array_equal(v, want[w])
    prompts, _ = TE.collect_prompts()
    texts = prompts + ["zzz qqq"]
    g_emb, g_kept, g_idx = TW.embed_texts(got, texts)
    w_emb, w_kept, w_idx = JW.embed_texts(want, texts)
    np.testing.assert_array_equal(g_emb, w_emb)
    assert g_kept == w_kept and g_idx == w_idx and len(g_idx) == len(prompts)


def test_analyze_clustering_equals_jax():
    prompts, cats = TE.collect_prompts()
    assert (prompts, cats) == JE.collect_prompts()
    emb = np.random.default_rng(0).standard_normal((len(prompts), 24)
                                                   ).astype(np.float32)
    assert TE.analyze_clustering(emb, cats) == JE.analyze_clustering(emb, cats)


def test_embed_prompts_matches_jax(tmp_path, monkeypatch):
    params = jax.tree.map(np.asarray, JA.init_tiny(jax.random.PRNGKey(0)))
    pt = tmp_path / "tiny.pt"
    JTI.export_atht_checkpoint(params, str(pt))
    prompts, _ = TE.collect_prompts()
    monkeypatch.setenv("ATSM_TOKENIZER_DIR",
                       str(write_bpe_vocab(prompts, tmp_path / "vocab")))
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    monkeypatch.setattr(JA, "init", JA.init_tiny)
    want = JE.embed_prompts(prompts, str(pt))
    got = TE.embed_prompts(prompts, pt, device="cpu")
    assert got.shape == want.shape == (len(prompts), 512)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_main_writes_the_report(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    pytest.importorskip("sklearn")
    monkeypatch.setenv("ATSM_TINY_MODEL", "1")
    TE.main(["--device", "cpu", "--output-dir", str(tmp_path)])
    report = json.loads((tmp_path / "report.json").read_text())
    assert set(report["clap"]) == {"intra_category_mean",
                                   "inter_category_mean", "separation"}
    assert report["word2vec"]["backend"] == "native"
    for name in ("cosine_similarity.png", "projection_pca.png",
                 "cosine_similarity_word2vec.png"):
        assert (tmp_path / name).read_bytes()[:4] == b"\x89PNG"
