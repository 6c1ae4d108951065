"""The CLAPSep baseline (Ma et al. 2024) in PyTorch.

Counterpart of ``audio_to_sheet_music_tpu/models/clapsep.py``, the
benchmark's third model: language-queried magnitude masking of a mono
32 kHz spectrogram, after the reference's ``model_config``.

- Front end: STFT magnitude (n_fft 1024, hop 320: the hop does not divide
  the window; ``torch.istft`` inverts it), ``log1p(mag * spec_factor)``.
- Query: ``concat(pos_emb, neg_emb)`` CLAP text embeddings (1024 wide)
  FiLM-modulate every pre-LN transformer block.
- A time-axis U-Net of such blocks (pair mean-pool down, edge-padding an
  odd length; repeat-2 up, skips added), then ``n_masker_layer`` blocks at
  ``d_attn`` and a sigmoid mask over the mixture magnitude; the mixture
  phase is ``z / max(|z|, 1e-8)``; iSTFT.

Attention is the port's plain ``nn.attention.mha`` (matmul and softmax).
The seeded init draws from the JAX init's distributions, not its numbers.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn import core as L
from ..nn.attention import MHA, mha
from ..ops import dsp

SAMPLE_RATE = 32000
CHUNK_SECONDS = 10.0
OVERLAP_SECONDS = 1.0

# natural-language stem queries of the reference benchmark
CLAPSEP_PROMPTS = {
    "drums": "drums and percussion",
    "bass": "bass guitar and bass sounds",
    "vocals": "singing voice and vocals",
    "other": "other musical instruments",
}


@dataclasses.dataclass(frozen=True)
class ClapSepConfig:
    """The reference ``model_config``."""

    lan_embed_dim: int = 1024           # concat(pos, neg) query width
    depths: tuple = (1, 1, 1, 1)        # U-Net stages (blocks per stage)
    embed_dim: int = 128                # stage-0 width scale marker
    d_attn: int = 640                   # transformer width
    n_masker_layer: int = 3
    phase: bool = False                 # magnitude mask only
    spec_factor: float = 8.0            # log1p compression gain
    n_fft: int = 1024
    hop: int = 320
    num_heads: int = 8

    @property
    def bins(self) -> int:
        return self.n_fft // 2 + 1


TINY = ClapSepConfig(lan_embed_dim=1024, depths=(1, 1), d_attn=64,
                     n_masker_layer=1, n_fft=256, hop=64, num_heads=2)


class Block(nn.Module):
    """Pre-LN self-attention block with FiLM conditioning."""

    def __init__(self, cfg: ClapSepConfig, gen=None):
        super().__init__()
        d = cfg.d_attn
        self.attn = MHA(d, gen)
        self.film = L.Linear(cfg.lan_embed_dim, 2 * d, gen)
        self.linear1 = L.Linear(d, 4 * d, gen)
        self.linear2 = L.Linear(4 * d, d, gen)
        self.norm1 = L.Norm(d)
        self.norm2 = L.Norm(d)


class ClapSep(nn.Module):
    def __init__(self, cfg: ClapSepConfig = ClapSepConfig(), gen=None):
        super().__init__()
        self.cfg = cfg

        def stage(depth):
            return nn.ModuleList([Block(cfg, gen) for _ in range(depth)])

        self.embed = L.Linear(cfg.bins, cfg.d_attn, gen)
        self.encoder = nn.ModuleList([stage(d) for d in cfg.depths])
        self.decoder = nn.ModuleList([stage(d) for d in cfg.depths[::-1]])
        self.masker = stage(cfg.n_masker_layer)
        self.head = L.Linear(cfg.d_attn, cfg.bins, gen)


def _block_apply(p: Block, x: torch.Tensor, query: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    """x: (B, L, D); query: (B, lan_embed_dim).  FiLM applies after the
    attention residual."""
    h = L.layer_norm(p.norm1, x)
    x = x + mha(p.attn, h, h, h, num_heads)
    gamma, beta = L.linear(p.film, query).chunk(2, dim=-1)
    x = x * (1.0 + gamma[:, None, :]) + beta[:, None, :]
    h = L.layer_norm(p.norm2, x)
    return x + L.linear(p.linear2, L.gelu(L.linear(p.linear1, h)))


def _downsample(x: torch.Tensor) -> torch.Tensor:
    """(B, L, D) -> (B, ceil(L / 2), D) pair mean, the last frame repeated
    for an odd L."""
    b, n, d = x.shape
    if n % 2:
        x = torch.cat([x, x[:, -1:]], dim=1)
        n += 1
    return x.reshape(b, n // 2, 2, d).mean(dim=2)


def _upsample(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """(B, L, D) -> (B, target_len, D): each frame twice, cropped."""
    return x.repeat_interleave(2, dim=1)[:, :target_len]


def apply_mask_net(p: ClapSep, feats: torch.Tensor, query: torch.Tensor,
                   cfg: ClapSepConfig) -> torch.Tensor:
    """(B, L, bins) compressed magnitude -> (B, L, bins) sigmoid mask."""
    x = L.linear(p.embed, feats)
    skips = []
    for stage in p.encoder:
        for blk in stage:
            x = _block_apply(blk, x, query, cfg.num_heads)
        skips.append(x)
        x = _downsample(x)
    for stage, skip in zip(p.decoder, skips[::-1]):
        x = _upsample(x, skip.shape[1]) + skip
        for blk in stage:
            x = _block_apply(blk, x, query, cfg.num_heads)
    for blk in p.masker:
        x = _block_apply(blk, x, query, cfg.num_heads)
    return torch.sigmoid(L.linear(p.head, x))


def forward(p: ClapSep, wav: torch.Tensor, embed_pos: torch.Tensor,
            embed_neg: torch.Tensor) -> torch.Tensor:
    """The reference's ``inference_from_data``: (B, T) mono 32 kHz chunks
    and (B, 512) CLAP text embeddings -> (B, T) separated waveforms."""
    cfg = p.cfg
    t = wav.shape[-1]
    z = dsp.stft(wav.float(), cfg.n_fft, cfg.hop)              # (B, F, L)
    mag = z.abs()
    feats = torch.log1p(mag * cfg.spec_factor).transpose(1, 2)
    query = torch.cat([embed_pos, embed_neg], dim=-1)
    mask = apply_mask_net(p, feats, query, cfg)                 # (B, L, F)
    masked = mag * mask.transpose(1, 2)
    phase = z / torch.clamp(mag, min=1e-8)
    return dsp.istft(masked * phase, t, cfg.n_fft, cfg.hop)


def param_count(p: nn.Module) -> int:
    return sum(t.numel() for t in p.parameters())
