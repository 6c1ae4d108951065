"""Prompt-embedding analysis: the counterpart of
``audio_to_sheet_music_tpu/apps/embedding_tool.py``.

    python -m audio_to_sheet_music_tpu_torch.apps.embedding_tool \\
        [--checkpoint ...] [--output-dir embedding_analysis] \\
        [--tensorboard] [--device cuda|cpu]

Embeds the stem prompt vocabulary (and the extra instrument terms violin,
viola, cello) with the CLAP text tower on ``--device`` (the card unless
``cpu``), then writes:

- the pairwise cosine-similarity matrix (PNG heatmap; JSON report),
- 2-D PCA and t-SNE projections (PNG scatter, coloured per stem category),
- the intra- against inter-category similarity statistics,
- with ``--tensorboard``, an embedding-projector export.

The Word2Vec leg always runs: gensim ``KeyedVectors`` when
``ATSM_W2V_PATH`` names local vectors, else the bundled skip-gram
(``text.word2vec``) trained on an offline music corpus.  ``main`` needs
matplotlib and scikit-learn (imported where they are used); UMAP is
optional and skipped with a note.  The model comes from
``atht.load_from_env`` with ``--checkpoint`` (a reference ``.pt``, an
``.npz`` or a training checkpoint directory).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

EXTRA_TERMS = ["violin", "viola", "cello"]


def collect_prompts():
    from ..text.prompts import STEM_PROMPTS

    prompts, categories = [], []
    for stem, variants in STEM_PROMPTS.items():
        for v in variants:
            prompts.append(v)
            categories.append(stem)
    for term in EXTRA_TERMS:
        prompts.append(term)
        categories.append("strings")
    return prompts, categories


@torch.inference_mode()
def embed_prompts(prompts, checkpoint=None, normalize: bool = True,
                  device="cuda", model=None) -> np.ndarray:
    """CLAP text embeddings ``(len(prompts), 512)`` computed on ``device``.

    ``model`` defaults to ``atht.load_from_env(checkpoint)``; a model marked
    ``pretrained`` refuses the hash-tokenizer fallback."""
    from ..infer.session import open_device
    from ..models import atht, clap_text
    from ..text.tokenizer import default_tokenizer

    device = open_device(device, "embed_prompts")
    if model is None:
        model = atht.load_from_env(checkpoint)
    ids, mask = default_tokenizer(require_real=model.pretrained)(prompts)
    fn = clap_text.get_text_features if normalize else clap_text.text_embeds
    emb = fn(model.clap.to(device), torch.from_numpy(ids).to(device),
             torch.from_numpy(mask).to(device))
    return emb.float().cpu().numpy()


def analyze_clustering(emb: np.ndarray, categories) -> dict:
    """Mean cosine similarity within and across categories, and their
    difference."""
    emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    sim = emb @ emb.T
    cats = np.asarray(categories)
    intra, inter = [], []
    n = len(cats)
    for i in range(n):
        for j in range(i + 1, n):
            (intra if cats[i] == cats[j] else inter).append(sim[i, j])
    return {
        "intra_category_mean": float(np.mean(intra)),
        "inter_category_mean": float(np.mean(inter)),
        "separation": float(np.mean(intra) - np.mean(inter)),
    }


def reduce_dimensions(emb: np.ndarray, method: str = "pca") -> np.ndarray:
    if method == "pca":
        from sklearn.decomposition import PCA

        return PCA(n_components=2).fit_transform(emb)
    if method == "tsne":
        from sklearn.manifold import TSNE

        perplexity = min(5, len(emb) - 1)
        return TSNE(n_components=2, perplexity=perplexity,
                    random_state=0).fit_transform(emb)
    if method == "umap":
        import umap  # optional

        return umap.UMAP(n_components=2, random_state=0).fit_transform(emb)
    raise ValueError(method)


def _heatmap(plt, sim, labels, path, title=None) -> None:
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(sim, cmap="viridis")
    ax.set_xticks(range(len(labels)), labels, rotation=90, fontsize=7)
    ax.set_yticks(range(len(labels)), labels, fontsize=7)
    if title:
        ax.set_title(title)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _scatter(plt, pts, labels, colours, title, path) -> None:
    fig, ax = plt.subplots(figsize=(7, 6))
    ax.scatter(pts[:, 0], pts[:, 1], c=colours, cmap="tab10")
    for p, (x, y) in zip(labels, pts):
        ax.annotate(p, (x, y), fontsize=7)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _cosine(emb: np.ndarray) -> np.ndarray:
    unit = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    return unit @ unit.T


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Prompt embedding analysis")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--output-dir", default="embedding_analysis")
    ap.add_argument("--tensorboard", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    prompts, categories = collect_prompts()
    emb = embed_prompts(prompts, args.checkpoint, device=args.device)
    report = {"prompts": prompts, "categories": categories,
              "clap": analyze_clustering(emb, categories)}
    _heatmap(plt, _cosine(emb), prompts, out / "cosine_similarity.png")

    colors = {c: i for i, c in enumerate(sorted(set(categories)))}
    for method in ("pca", "tsne", "umap"):
        try:
            pts = reduce_dimensions(emb, method)
        except ImportError:
            print(f"{method}: dependency unavailable, skipped")
            continue
        _scatter(plt, pts, prompts, [colors[c] for c in categories],
                 f"CLAP prompt embeddings — {method.upper()}",
                 out / f"projection_{method}.png")

    from ..text import word2vec as w2v_mod

    w2v = w2v_mod.load_or_train()
    w2v_emb, kept, kept_idx = w2v_mod.embed_texts(w2v, prompts)
    if len(kept) >= 2:
        kept_cats = [categories[i] for i in kept_idx]
        report["word2vec"] = {"backend": w2v.backend, "dim": int(w2v.dim),
                              "n_prompts": len(kept),
                              **analyze_clustering(w2v_emb, kept_cats)}
        _heatmap(plt, _cosine(w2v_emb), kept,
                 out / "cosine_similarity_word2vec.png",
                 "Word2Vec cosine similarity")
        _scatter(plt, reduce_dimensions(w2v_emb, "pca"), kept,
                 [colors[c] for c in kept_cats],
                 "Word2Vec prompt embeddings — PCA",
                 out / "projection_word2vec_pca.png")
        report["comparison"] = {
            "clap_separation": report["clap"]["separation"],
            "word2vec_separation": report["word2vec"]["separation"]}

    if args.tensorboard:
        try:
            from torch.utils.tensorboard import SummaryWriter

            w = SummaryWriter(str(out / "tb"))
            w.add_embedding(emb, metadata=prompts, tag="clap_prompts")
            w.close()
        except Exception as e:  # noqa: BLE001
            report["tensorboard"] = f"skipped ({e})"

    (out / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report["clap"], indent=2))
    print(f"analysis written to {out}")


if __name__ == "__main__":
    main()
