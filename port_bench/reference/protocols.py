"""The benchmark's entries, computed again by the plain reference: a song
cut into chunks and put back together by a weighted overlap-add, its
int16 quantisation, and steps of head training (loss, backward, global-norm
clip, AdamW under a cosine schedule), from the start or resumed.  Every function takes the inputs the
benchmark made and the parameters by name; nothing comes from the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import atht, text
from .layers import F32, Params, Prec

SR = 44100


def set_f32() -> None:
    """True float32 products: no TF32 in matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fade(segment: int, overlap: int, device) -> torch.Tensor:
    """Ones with linear ramps over ``overlap`` samples at both ends,
    ``min(fade_in, fade_out)`` where they meet."""
    w = torch.ones(segment, device=device)
    if overlap > 1:
        ramp = torch.linspace(0.0, 1.0, overlap, device=device)
        w[:overlap] = torch.minimum(w[:overlap], ramp)
        w[segment - overlap:] = torch.minimum(w[segment - overlap:],
                                              ramp.flip(0))
    return w


def chunk_count(length: int, segment: int, overlap: int) -> int:
    """Chunks whose start lies inside the song: ceil(length / hop)."""
    overlap = min(overlap, segment - 1)
    return max(1, math.ceil(length / (segment - overlap)))


def separate(forward, song: torch.Tensor, segment: int, overlap: int,
             block: int = 8) -> torch.Tensor:
    """A (2, T) float song through ``forward`` ((n, 2, seg) -> (n, C, seg))
    in blocks of ``block`` chunks, weighted overlap-add, divided by the
    summed weights -> (C, T)."""
    overlap = min(overlap, segment - 1)
    hop = segment - overlap
    length = song.shape[-1]
    n = chunk_count(length, segment, overlap)
    total = (n - 1) * hop + segment
    padded = torch.nn.functional.pad(song, (0, total - length))
    w = fade(segment, overlap, song.device)
    acc = wsum = None
    for i0 in range(0, n, block):
        idx = range(i0, min(n, i0 + block))
        chunks = torch.stack([padded[:, i * hop:i * hop + segment] for i in idx])
        out = forward(chunks)
        if acc is None:
            acc = out.new_zeros((out.shape[1], total))
            wsum = out.new_zeros((total,))
        for j, i in enumerate(idx):
            acc[:, i * hop:i * hop + segment] += out[j] * w
            wsum[i * hop:i * hop + segment] += w
    return (acc / torch.clamp(wsum, min=1e-8))[:, :length]


def prompt_embeddings(p: Params, prompts: Sequence[str], normalize: bool,
                      device, prec: Prec = F32) -> torch.Tensor:
    """(S, 512) text embeddings, one prompt at a time as the program
    tokenises them (no padding between prompts)."""
    rows = []
    for prompt in prompts:
        ids, mask = text.tokenize([prompt])
        rows.append(text.embed(p, torch.from_numpy(ids).to(device),
                               torch.from_numpy(mask).to(device), normalize,
                               prec)[0])
    return torch.stack(rows)


def atht_stems(p: Params, cfg: Dict, song: torch.Tensor, embs: torch.Tensor,
               segment: int, overlap: int, prec: Prec = F32,
               block: int = 8) -> torch.Tensor:
    """A float (2, T) song -> (S, 2, T) stems of the text-conditioned model."""
    s = embs.shape[0]

    def fwd(chunks):
        out = atht.forward(p, chunks, embs, cfg, prec)      # (S, b, 2, seg)
        return out.permute(1, 0, 2, 3).reshape(chunks.shape[0], 2 * s, -1)

    with torch.no_grad():
        flat = separate(fwd, song.float(), segment, overlap, block)
    return flat.reshape(s, 2, -1)


def pcm_scale(song_i16: np.ndarray) -> float:
    """Twice the mixture's peak, the shared scale of a 4-stem int16 sweep."""
    peak = max(int(song_i16.max(initial=0)), -int(song_i16.min(initial=0)))
    return max(2.0 * peak / 32768.0, 1e-8)


def quantise(stems: torch.Tensor, scale: float) -> torch.Tensor:
    """Float stems -> int16 levels ``round(x / scale * 32767)``, clipped."""
    return torch.clamp(torch.round(stems / scale * 32767.0), -32768, 32767)


# ---------------------------------------------------------------------------
# Head training
# ---------------------------------------------------------------------------

def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).float()


def combined_loss(est: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """0.9 x negative SDR + 0.1 x negative SI-SDR, each clamped at ±30 dB
    per item and averaged over the batch (the source's ``src/loss.py``)."""
    e, t = _flat(est), _flat(tgt)
    d = 1e-8
    sdr = 10 * torch.log10((torch.sum(t ** 2, -1) + d)
                           / (torch.sum((t - e) ** 2, -1) + d))
    e0 = e - e.mean(-1, keepdim=True)
    t0 = t - t.mean(-1, keepdim=True)
    st = (torch.sum(e0 * t0, -1, keepdim=True)
          / (torch.sum(t0 ** 2, -1, keepdim=True) + d)) * t0
    si = 10 * torch.log10((torch.sum(st ** 2, -1) + d)
                          / (torch.sum((e0 - st) ** 2, -1) + d))
    return (0.9 * -torch.clamp(sdr, -30, 30).mean()
            + 0.1 * -torch.clamp(si, -30, 30).mean())


def cosine(count: int, total: int, alpha: float) -> float:
    t = min(count, total)
    return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / total)) + alpha


def train_steps(p: Params, cfg: Dict, batches: List[Dict[str, np.ndarray]],
                opt: Dict, device, prec: Prec = F32,
                start: Optional[Dict] = None) -> Dict:
    """Steps of head training from ``p`` on ``batches`` (host arrays:
    mixture, target, input_ids, attention_mask): the frozen towers without
    gradients, the head's loss and gradients, the global-norm clip (scale
    ``clip / norm`` where ``norm >= clip``) and AdamW (decoupled decay,
    eps outside the root) with the cosine factor at the count of earlier
    updates.  ``start`` resumes a run part-way: the head (``head``), the
    first and second moments (``m``, ``v``) by name and the count of
    updates before (``count``); without it the head is ``p``'s and the
    moments are zero.  Returns each step's loss and global gradient norm
    before the clip, the first step's clipped gradients and the head after
    the last step, by name."""
    src = p if start is None else start["head"]
    head = {k: src[k].detach().clone().float().requires_grad_(True)
            for k in p if k.startswith("head.")}
    frozen = {k: v for k, v in p.items() if not k.startswith("head.")}
    if start is None:
        m = {k: torch.zeros_like(v) for k, v in head.items()}
        v2 = {k: torch.zeros_like(v) for k, v in head.items()}
        count = 0
    else:
        m = {k: start["m"][k].detach().clone().float() for k in head}
        v2 = {k: start["v"][k].detach().clone().float() for k in head}
        count = int(start["count"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, norms, first_grads = [], [], None
    for step, batch in enumerate(batches):
        mix = torch.from_numpy(np.ascontiguousarray(batch["mixture"])).to(device)
        tgt = torch.from_numpy(np.ascontiguousarray(batch["target"])).to(device)
        ids = torch.from_numpy(batch["input_ids"]).to(device)
        mask = torch.from_numpy(batch["attention_mask"]).to(device)
        with torch.no_grad():
            emb = text.embed(frozen, ids, mask, False, prec)
            e = atht.encode(frozen, mix, cfg, prec)
        est = atht.head_rows({**frozen, **head}, e, emb, cfg, prec)[0]
        loss = combined_loss(est, tgt)
        grads = torch.autograd.grad(loss, list(head.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for g, w in zip(grads, head.values())]
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        norms.append(float(norm))
        if norm >= opt["grad_clip"]:
            grads = [g * (opt["grad_clip"] / norm).float() for g in grads]
        if step == 0:
            first_grads = {k: g.detach().clone() for k, g in zip(head, grads)}
        n = count + step
        lr = opt["lr"] * cosine(n, opt["total_steps"], opt["eta_min_ratio"])
        with torch.no_grad():
            for (k, w), g in zip(head.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).add_(g * g, alpha=1 - b2)
                mhat = m[k] / (1 - b1 ** (n + 1))
                vhat = v2[k] / (1 - b2 ** (n + 1))
                w.mul_(1 - lr * opt["weight_decay"])
                w.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
        losses.append(float(loss.detach()))
    return {"losses": losses, "norms": norms, "first_grads": first_grads,
            "head": {k: w.detach() for k, w in head.items()}}
