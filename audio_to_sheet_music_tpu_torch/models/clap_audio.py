"""CLAP audio tower (HTSAT-tiny Swin transformer) in PyTorch.

Counterpart of ``audio_to_sheet_music_tpu/models/clap_audio.py``:
``ClapAudioModel`` + projection of ``laion/clap-htsat-unfused`` (28.19 M
parameters), parameter names as in the HF state dict below
``audio_model.audio_encoder.`` (``convert/torch_import`` strips it).  The
pipeline, as HF ``ClapAudioEncoder.forward``:

1. BatchNorm over the 64 mel bins (eval statistics).
2. ``reshape_mel2img``: (B, 1, T <= 1024, 64) log-mel -> bicubic time
   resize to 1024 (torch's kernel, a = -0.75, ``align_corners=True``, as an
   exact interpolation matrix built in numpy, not ``F.interpolate``, which
   computes its source positions in f32) -> the ``freq_ratio = 4`` time
   groups folded into frequency -> a (B, 1, 256, 256) image.
3. 4x4 / 4 patch embed -> LayerNorm -> 4 Swin stages (depths 2, 2, 6, 2,
   heads 4 / 8 / 16 / 32, window 8, every other block shifted by 4 with the
   -100 cross-group mask, relative position bias, post-norm MLP), patch
   merging between stages.
4. Final LayerNorm -> the HTSAT frequency regroup -> temporal mean pool ->
   projection 768 -> 512 -> 512 (ReLU).

Window attention is plain matmul and softmax (softmax in f32), as in the
JAX package.  ``audio_embeds`` is ``ClapAudioModelWithProjection``'s
un-normalised output; ``get_audio_features`` L2-normalises it.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..nn import core as L

SPEC_SIZE = 256
PATCH_SIZE = 4
PATCH_STRIDE = 4
NUM_MEL_BINS = 64
FREQ_RATIO = SPEC_SIZE // NUM_MEL_BINS          # 4
WINDOW = 8
DEPTHS = (2, 2, 6, 2)
NUM_HEADS = (4, 8, 16, 32)
EMBED_DIM = 96
HIDDEN = 768                                    # 96 * 2**3
PROJECTION_DIM = 512
LN_EPS = 1e-5
MLP_RATIO = 4


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, keys=(None, None, None)):
        super().__init__()
        self.query = L.Linear(dim, dim, keys[0])
        self.key = L.Linear(dim, dim, keys[1])
        self.value = L.Linear(dim, dim, keys[2])
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(((2 * WINDOW - 1) ** 2, heads)))


def _block(dim: int, heads: int, key) -> nn.ModuleDict:
    """The JAX ``_layer_init``: ``split(key, 7)``, q/k/v, the attention
    output, the MLP's two layers."""
    k = L.split(key, 7)
    return nn.ModuleDict({
        "layernorm_before": L.Norm(dim),
        "attention": nn.ModuleDict({
            "self": SelfAttention(dim, heads, k[:3]),
            "output": nn.ModuleDict({"dense": L.Linear(dim, dim, k[3])}),
        }),
        "layernorm_after": L.Norm(dim),
        "intermediate": nn.ModuleDict({
            "dense": L.Linear(dim, dim * MLP_RATIO, k[4])}),
        "output": nn.ModuleDict({
            "dense": L.Linear(dim * MLP_RATIO, dim, k[5])}),
    })


class BatchNorm(nn.Module):
    """BatchNorm2d over the mel bins, eval statistics only."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))


class ClapAudio(nn.Module):
    """HTSAT-tiny + projection at full width (there is no smaller member).
    Keys as the JAX ``clap_audio_init``: ``split(key, 16)`` handed out to
    the blocks and downsamplers stage by stage, then one split in three for
    the patch embedding and the projection."""

    def __init__(self, key=None):
        super().__init__()
        ki = iter(L.split(key, 16))
        stages = []
        for i, depth in enumerate(DEPTHS):
            dim = EMBED_DIM * 2 ** i
            stage = nn.ModuleDict({"blocks": nn.ModuleList(
                [_block(dim, NUM_HEADS[i], next(ki)) for _ in range(depth)])})
            if i < len(DEPTHS) - 1:
                stage["downsample"] = nn.ModuleDict({
                    "reduction": L.Linear(4 * dim, 2 * dim, next(ki),
                                          bias=False),
                    "norm": L.Norm(4 * dim)})
            stages.append(stage)
        kp = L.split(next(ki), 3)
        self.patch_embed = nn.ModuleDict({
            "proj": L.Conv2d(1, EMBED_DIM, (PATCH_SIZE, PATCH_SIZE), kp[0]),
            "norm": L.Norm(EMBED_DIM)})
        self.layers = nn.ModuleList(stages)
        self.batch_norm = BatchNorm(NUM_MEL_BINS)
        self.norm = L.Norm(HIDDEN)
        self.audio_projection = nn.ModuleDict({
            "linear1": L.Linear(HIDDEN, PROJECTION_DIM, kp[1]),
            "linear2": L.Linear(PROJECTION_DIM, PROJECTION_DIM, kp[2])})


# ---------------------------------------------------------------------------
# mel -> image
# ---------------------------------------------------------------------------

def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch's bicubic kernel (Keys, a = -0.75)."""
    ax = np.abs(x)
    return np.where(ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
                    np.where(ax < 2, a * ax ** 3 - 5 * a * ax ** 2
                             + 8 * a * ax - 4 * a, 0.0))


@functools.lru_cache(maxsize=8)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) torch ``bicubic, align_corners=True`` resize as a
    matrix: positions in float64, taps summed into float32."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    pos = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    base = np.floor(pos).astype(int)
    w = np.zeros((n_out, n_in), np.float32)
    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, n_in - 1)
        w[np.arange(n_out), idx] += _cubic_kernel(pos - (base + tap))
    return w


def _resize(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    m = torch.from_numpy(_resize_matrix(x.shape[dim], n_out)).to(x.device)
    return torch.movedim(torch.matmul(m, torch.movedim(x, dim, -2)), -2, dim)


def reshape_mel2img(x: torch.Tensor) -> torch.Tensor:
    """(B, 1, T, 64) -> (B, 1, 256, 256) (HF ``reshape_mel2img``)."""
    b, c, t, f = x.shape
    spec_width = SPEC_SIZE * FREQ_RATIO           # 1024
    spec_height = SPEC_SIZE // FREQ_RATIO         # 64
    if t > spec_width or f > spec_height:
        raise ValueError(f"mel input {tuple(x.shape)} exceeds "
                         f"({spec_width}, {spec_height})")
    if t < spec_width:
        x = _resize(x, spec_width, 2)
    if f < spec_height:
        x = _resize(x, spec_height, 3)
    b, c, t, f = x.shape
    x = x.reshape(b, c * FREQ_RATIO, t // FREQ_RATIO, f).transpose(2, 3)
    return x.reshape(b, c, f * FREQ_RATIO, t // FREQ_RATIO)


# ---------------------------------------------------------------------------
# Swin blocks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _rel_pos_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)                            # (W², W²)


@functools.lru_cache(maxsize=16)
def _shift_mask(h: int, w: int, win: int, shift: int) -> np.ndarray:
    """SW-MSA mask (n_windows, W², W²): -100 between tokens of different
    groups of the shifted image, else 0."""
    img = np.zeros((h, w), np.int32)
    count = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = count
            count += 1
    wins = img.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, win * win)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def _window_reverse(x: torch.Tensor, win: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(-1, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def _window_attention(p: nn.ModuleDict, x: torch.Tensor, heads: int, win: int,
                      mask: np.ndarray | None) -> torch.Tensor:
    """x: (B * nW, W², C) window tokens."""
    bn, n, c = x.shape
    dh = c // heads
    sp = p["self"]

    def split(t):
        return t.reshape(bn, n, heads, dh).transpose(1, 2)

    q = split(L.linear(sp.query, x))
    k = split(L.linear(sp.key, x))
    v = split(L.linear(sp.value, x))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
    idx = torch.from_numpy(_rel_pos_index(win).reshape(-1)).to(x.device)
    bias = sp.relative_position_bias_table[idx]
    scores = scores + bias.reshape(n, n, heads).permute(2, 0, 1)[None].to(
        scores.dtype)
    if mask is not None:
        n_w = mask.shape[0]
        m = torch.from_numpy(mask).to(x.device, scores.dtype)
        scores = (scores.reshape(bn // n_w, n_w, heads, n, n)
                  + m[None, :, None]).reshape(bn, heads, n, n)
    attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    ctx = torch.matmul(attn, v).transpose(1, 2).reshape(bn, n, c)
    return L.linear(p["output"]["dense"], ctx)


def _swin_layer(p: nn.ModuleDict, x: torch.Tensor, hw: Tuple[int, int],
                heads: int, shift: int) -> torch.Tensor:
    """x: (B, H * W, C); a Swin block, cyclically shifted when ``shift``."""
    h, w = hw
    win = WINDOW
    if min(h, w) <= win:
        shift, win = 0, min(h, w)
    b, _, c = x.shape
    shortcut = x
    x = L.layer_norm(p["layernorm_before"], x, LN_EPS).reshape(b, h, w, c)
    pad_b = (win - h % win) % win
    pad_r = (win - w % win) % win
    if pad_b or pad_r:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    mask = None
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = _shift_mask(hp, wp, win, shift)
    attn = _window_attention(p["attention"], _window_partition(x, win), heads,
                             win, mask)
    x = _window_reverse(attn.reshape(-1, win, win, c), win, hp, wp)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    if pad_b or pad_r:
        x = x[:, :h, :w]
    x = shortcut + x.reshape(b, h * w, c)
    y = L.layer_norm(p["layernorm_after"], x, LN_EPS)
    y = L.gelu(L.linear(p["intermediate"]["dense"], y))
    return x + L.linear(p["output"]["dense"], y)


def _patch_merge(p: nn.ModuleDict, x: torch.Tensor, hw: Tuple[int, int]
                 ) -> torch.Tensor:
    h, w = hw
    b, _, c = x.shape
    x = x.reshape(b, h, w, c)
    if h % 2 or w % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1).reshape(b, -1, 4 * c)
    return L.linear(p["reduction"], L.layer_norm(p["norm"], x, LN_EPS))


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------

def encode(p: ClapAudio, input_features: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 1, T, 64) log-mel -> (last_hidden (B, 768, 2, 32), pooled
    (B, 768))."""
    bn = p.batch_norm
    x = ((input_features - bn.running_mean) * torch.rsqrt(bn.running_var
                                                          + 1e-5))
    x = x * bn.weight + bn.bias
    img = reshape_mel2img(x)                           # (B, 1, 256, 256)
    frames_num = img.shape[2]

    pe = p.patch_embed
    h = L.conv2d(pe["proj"], img, stride=(PATCH_STRIDE, PATCH_STRIDE),
                 padding=((PATCH_SIZE - PATCH_STRIDE) // 2,) * 2)
    b, c, gh, gw = h.shape
    h = L.layer_norm(pe["norm"], h.reshape(b, c, gh * gw).transpose(1, 2),
                     LN_EPS)
    hw = (gh, gw)
    for i, stage in enumerate(p.layers):
        for j, blk in enumerate(stage["blocks"]):
            h = _swin_layer(blk, h, hw, NUM_HEADS[i],
                            0 if j % 2 == 0 else WINDOW // 2)
        if "downsample" in stage:
            h = _patch_merge(stage["downsample"], h, hw)
            hw = ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
    h = L.layer_norm(p.norm, h, LN_EPS)

    # the HTSAT frequency regroup, then a temporal mean pool
    bsz, _, nch = h.shape
    freq_shape = frames_num // (2 ** (len(DEPTHS) - 1)) // PATCH_STRIDE
    temporal_shape = img.shape[3] // (2 ** (len(DEPTHS) - 1)) // PATCH_STRIDE
    last = h.transpose(1, 2).reshape(bsz, nch, freq_shape, temporal_shape)
    c_freq_bin = freq_shape // FREQ_RATIO
    last = last.reshape(bsz, nch, freq_shape // c_freq_bin, c_freq_bin,
                        temporal_shape)
    last = last.permute(0, 1, 3, 2, 4).reshape(bsz, nch, c_freq_bin, -1)
    return last, last.reshape(bsz, nch, -1).mean(dim=-1)


def _project(p: ClapAudio, pooled: torch.Tensor) -> torch.Tensor:
    proj = p.audio_projection
    return L.linear(proj["linear2"],
                    torch.relu(L.linear(proj["linear1"], pooled)))


def audio_embeds(p: ClapAudio, input_features: torch.Tensor) -> torch.Tensor:
    """``ClapAudioModelWithProjection().audio_embeds`` (not normalised)."""
    return _project(p, encode(p, input_features)[1])


def get_audio_features(p: ClapAudio, input_features: torch.Tensor
                       ) -> torch.Tensor:
    """``ClapModel.get_audio_features``: the projection, L2-normalised."""
    emb = audio_embeds(p, input_features)
    norm = torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True)
    return (emb / norm).to(emb.dtype)
