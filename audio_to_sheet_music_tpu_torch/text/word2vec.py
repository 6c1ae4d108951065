"""The Word2Vec leg of the prompt-embedding comparison.

Counterpart of ``audio_to_sheet_music_tpu/text/word2vec.py`` (numpy only,
the same numbers for the same seed).  The reference loads gensim's
``word2vec-google-news-300``, which needs the network; this module gives
the same capability offline:

- ``Word2Vec.train``: a vectorised skip-gram trainer with negative sampling
  (numpy, full batch per epoch; the bundled corpus is small, so it runs in
  well under a second);
- ``MUSIC_CORPUS``: an offline corpus of music descriptions covering the
  stem prompts' vocabulary, so every prompt word is in the vocabulary;
- ``load_or_train``: gensim ``KeyedVectors`` from ``ATSM_W2V_PATH`` when
  gensim and the file are there, else the native model;
- ``embed_texts``: the mean of a text's in-vocabulary word vectors,
  skipping unknown words and dropping texts with none.
"""

from __future__ import annotations

import os
import re
from typing import List, Sequence, Tuple

import numpy as np

# Offline training corpus: short music descriptions touching every word the
# prompt table uses (text/prompts.py + the violin/viola/cello extra terms).
MUSIC_CORPUS = [
    "the drums keep the beat with the drum kit and percussion",
    "a drummer plays the drum kit with loud percussion and cymbals",
    "drums and percussion drive the rhythm of the song",
    "the percussion section includes drums cymbals and a snare drum",
    "the bass guitar plays a deep bass line under the song",
    "a bass line from the bass guitar anchors the groove",
    "the bass player plays the electric bass guitar",
    "deep bass sounds and a walking bass line support the band",
    "the vocals carry the melody with a singing voice",
    "a singer performs the vocals with a clear voice",
    "singing voice and backing vocals fill the chorus",
    "the voice of the singer leads while the vocals harmonize",
    "other instruments play the accompaniment behind the singer",
    "the accompaniment features piano guitar and other instruments",
    "many instruments join the accompaniment in the background",
    "keyboard piano and synth are other instruments in the mix",
    "the violin and viola play the string melody",
    "a cello joins the violin and viola in the string section",
    "the string quartet has two violins a viola and a cello",
    "violin viola and cello are bowed string instruments",
    "the guitar plays chords while the piano plays the melody",
    "a song mixes drums bass vocals and other instruments",
    "the band plays drums bass guitar piano and vocals",
    "percussion bass accompaniment and singing blend in the mix",
]


def _tokenize(text: str) -> List[str]:
    return re.findall(r"[a-z']+", text.lower())


class Word2Vec:
    """Minimal KeyedVectors-compatible container (`in`, ``[]``)."""

    def __init__(self, vectors, backend: str = "native"):
        """``vectors``: any ``in``/``[]`` mapping of word -> vector — a
        plain dict or a gensim ``KeyedVectors`` (kept as-is; copying e.g.
        word2vec-google-news-300 into a dict would double its ~3.6 GB)."""
        self.vectors = vectors
        self.backend = backend
        if hasattr(vectors, "vector_size"):          # gensim KeyedVectors
            self.dim = int(vectors.vector_size)
        else:
            self.dim = len(next(iter(vectors.values())))

    def __contains__(self, word: str) -> bool:
        return word in self.vectors

    def __getitem__(self, word: str) -> np.ndarray:
        return self.vectors[word]

    @classmethod
    def train(cls, sentences: Sequence[str], dim: int = 64, window: int = 2,
              negative: int = 5, epochs: int = 600, lr: float = 8.0,
              seed: int = 0) -> "Word2Vec":
        """Skip-gram with negative sampling, full-batch vectorised updates.

        Gradients are AVERAGED over the pair batch (not per-pair SGD), so the
        per-word effective step stays bounded regardless of word frequency;
        ``lr`` is correspondingly larger than classic word2vec's 0.025.
        """
        rng = np.random.default_rng(seed)
        tokenized = [_tokenize(s) for s in sentences]
        vocab = sorted({w for s in tokenized for w in s})
        idx = {w: i for i, w in enumerate(vocab)}
        v = len(vocab)

        counts = np.zeros(v)
        pairs: List[Tuple[int, int]] = []
        for sent in tokenized:
            ids = [idx[w] for w in sent]
            for i, c in enumerate(ids):
                counts[c] += 1
                for j in range(max(0, i - window), min(len(ids), i + window + 1)):
                    if j != i:
                        pairs.append((c, ids[j]))
        centers = np.array([p[0] for p in pairs])
        contexts = np.array([p[1] for p in pairs])
        n = len(pairs)
        # unigram^0.75 negative-sampling table (word2vec convention)
        p_neg = counts ** 0.75
        p_neg /= p_neg.sum()

        w_in = (rng.random((v, dim)).astype(np.float32) - 0.5) / dim
        w_out = np.zeros((v, dim), np.float32)

        def sigmoid(x):
            return 1.0 / (1.0 + np.exp(-np.clip(x, -20.0, 20.0)))

        for epoch in range(epochs):
            step = (lr * (1.0 - epoch / epochs) + 1e-3) / n     # batch mean
            negs = rng.choice(v, size=(n, negative), p=p_neg)   # (N, K)
            ci = w_in[centers]                                  # (N, D)
            # positive pass
            co = w_out[contexts]
            g_pos = (sigmoid((ci * co).sum(-1)) - 1.0)[:, None] # (N, 1)
            d_ci = g_pos * co
            d_co = g_pos * ci
            # negative pass
            no = w_out[negs]                                    # (N, K, D)
            g_neg = sigmoid(np.einsum("nd,nkd->nk", ci, no))    # (N, K)
            d_ci += np.einsum("nk,nkd->nd", g_neg, no)
            d_no = g_neg[:, :, None] * ci[:, None, :]
            # scatter-add updates
            np.add.at(w_in, centers, -step * d_ci)
            np.add.at(w_out, contexts, -step * d_co)
            np.add.at(w_out, negs.reshape(-1), -step * d_no.reshape(-1, dim))

        return cls({w: w_in[idx[w]].copy() for w in vocab}, backend="native")


def load_or_train(dim: int = 64) -> Word2Vec:
    """gensim KeyedVectors from ``ATSM_W2V_PATH`` if possible, else native."""
    path = os.environ.get("ATSM_W2V_PATH")
    if path and os.path.exists(path):
        try:
            from gensim.models import KeyedVectors

            kv = KeyedVectors.load(path)
            return Word2Vec(kv, backend="gensim")
        except Exception as e:  # noqa: BLE001 — fall back, note why
            print(f"gensim vectors unavailable ({e}); training native w2v")
    return Word2Vec.train(MUSIC_CORPUS, dim=dim)


def embed_texts(w2v: Word2Vec, texts: Sequence[str]
                ) -> Tuple[np.ndarray, List[str], List[int]]:
    """Mean word vector per text (reference `embedding_comparison.py:115-140`).

    OOV words are skipped; texts with no in-vocabulary word are dropped.
    Returns ``(embeddings, kept_texts, kept_indices)``.
    """
    out, kept, kept_idx = [], [], []
    for i, text in enumerate(texts):
        vecs = [w2v[w] for w in _tokenize(text) if w in w2v]
        if vecs:
            out.append(np.mean(vecs, axis=0))
            kept.append(text)
            kept_idx.append(i)
    emb = (np.stack(out).astype(np.float32) if out
           else np.zeros((0, w2v.dim), np.float32))
    return emb, kept, kept_idx
