"""The CLAP text tower (``laion/clap-htsat-unfused``: RoBERTa-base, 12 post-LN
layers of 768 with 12 heads and FF 3072, a tanh pooler on the first token,
projection 768 -> 512 -> 512 with ReLU) in plain PyTorch, and the word-hash
tokenizer the benchmark's prompts go through (no BPE vocabulary is in the
repository).  Parameters under the HF state-dict names (``clap.*``)."""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .layers import F32, Params, Prec, attention, count_prefixed, gelu, layer_norm, lin

BOS, PAD, EOS = 0, 1, 2
VOCAB = 50265
MAX_TOKENS = 512
LN_EPS = 1e-12


def tokenize(prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Each lower-cased word -> ``3 + sha256(word)[:4] (little endian) mod
    (VOCAB - 3)``, framed by BOS / EOS, padded with PAD; int32 ids and
    0/1 mask."""
    seqs: List[List[int]] = []
    for p in prompts:
        ids = [BOS]
        for w in p.lower().split():
            h = int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little")
            ids.append(3 + h % (VOCAB - 3))
        ids.append(EOS)
        if len(ids) > MAX_TOKENS:
            ids = ids[:MAX_TOKENS - 1] + [EOS]
        seqs.append(ids)
    width = max(len(s) for s in seqs)
    ids = np.full((len(seqs), width), PAD, np.int32)
    mask = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
        mask[i, :len(s)] = 1
    return ids, mask


def fit(ids: np.ndarray, mask: np.ndarray, width: int
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Cut or pad (PAD / 0) the token axis to ``width``."""
    keep = min(width, ids.shape[1])
    out_ids = np.full((ids.shape[0], width), PAD, np.int32)
    out_mask = np.zeros((ids.shape[0], width), np.int32)
    out_ids[:, :keep] = ids[:, :keep]
    out_mask[:, :keep] = mask[:, :keep]
    return out_ids, out_mask


def embed(p: Params, ids: torch.Tensor, mask: torch.Tensor, normalize: bool,
          prec: Prec = F32) -> torch.Tensor:
    """(B, L) ids and mask -> (B, 512) projected text embeddings, L2
    normalised with ``normalize`` (``ClapModel.get_text_features``)."""
    ids, maskf = ids.long(), mask.float()
    pos = torch.cumsum(mask.long(), dim=1) * mask.long() + PAD
    x = (p["clap.embeddings.word_embeddings.weight"][ids]
         + p["clap.embeddings.position_embeddings.weight"][pos]
         + p["clap.embeddings.token_type_embeddings.weight"][0])
    x = layer_norm(p, "clap.embeddings.LayerNorm", x, LN_EPS)
    bias = ((1.0 - maskf) * torch.finfo(torch.float32).min)[:, None, None, :]
    hidden = x.shape[-1]
    heads = hidden // 64
    for i in range(count_prefixed(p, "clap.layer")):
        n = f"clap.layer.{i}"
        a = n + ".attention"
        ctx = attention(lin(p, a + ".self.query", x, prec),
                        lin(p, a + ".self.key", x, prec),
                        lin(p, a + ".self.value", x, prec), heads, bias, prec)
        x = layer_norm(p, a + ".output.LayerNorm",
                       lin(p, a + ".output.dense", ctx, prec) + x, LN_EPS)
        h = lin(p, n + ".output.dense",
                gelu(lin(p, n + ".intermediate.dense", x, prec)), prec)
        x = layer_norm(p, n + ".output.LayerNorm", h + x, LN_EPS)
    pooled = torch.tanh(lin(p, "clap.pooler.dense", x[:, 0], prec))
    emb = lin(p, "clap.text_projection.linear2",
              torch.relu(lin(p, "clap.text_projection.linear1", pooled, prec)),
              prec)
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb
