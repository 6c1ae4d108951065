"""AudioTextHTDemucs — text-conditioned single-stem separation in PyTorch.

Counterpart of ``audio_to_sheet_music_tpu/models/atht.py``: the frozen
HTDemucs encoders + cross-domain transformer (``models.htdemucs``), the
frozen CLAP text tower (``models.clap_text``) and the trained head
(``TextCrossAttention`` + ``FreqDecoder`` + ``TimeDecoder`` + 1x1 output
convs), then a sigmoid spectrogram mask with the mixture phase + iSTFT plus
a time-domain branch.

The reference's quirks are kept, since the head was trained through them:

- the decoders compare their frequency (time) size against the encoder's
  recorded *time-axis* lengths, so the freq decoder works on a
  (T_spec, T_spec) grid; skips are channel-truncated and resized;
- the mask multiplies CaC channels ``[:2]`` (left channel re/im) as the
  "stereo magnitude", and the phase divides by that signed value + 1e-8;
- the text cross-attention has one key, so its softmax is exactly 1 and the
  output is ``out_proj(v_proj(v))`` broadcast over the queries.

The model is an ``nn.Module`` with ``htdemucs``, ``clap`` and ``head``
children whose ``state_dict`` names are the JAX param tree's torch names
(``convert/jax_params.py``).  It is built frozen (no gradients); training
makes the head's parameters trainable (``train/step.py``), and ``forward``
runs the towers under ``torch.no_grad()`` so only the head records autograd.
The ``kernels`` argument of the forward pieces is an ``ops.select``
selection.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List

import torch
from torch import nn

from ..convert import jax_params
from ..nn import core as L
from ..nn import prng
from ..nn.attention import MHA
from ..ops import dsp, fused_norm
from ..ops.select import Kernels, resolve
from ..utils import profiling
from . import clap_text, htdemucs

MODEL_DIM = 384
TEXT_DIM = 512
DECODER_CHANNELS = [384, 192, 96, 48, 4]
SKIP_SCALE = 0.1
DEFAULT_HEAD = Path(__file__).resolve().parents[2] / "artifacts" / "trained_head.npz"


# ---------------------------------------------------------------------------
# Head modules
# ---------------------------------------------------------------------------

class TextCrossAttention(nn.Module):
    """The JAX ``text_cross_attention_init``: ``split(key, 6)`` for the q, k
    and v projections, the attention and the two MLP layers."""

    def __init__(self, feat_dim: int = MODEL_DIM, text_dim: int = TEXT_DIM,
                 key=None):
        super().__init__()
        k = L.split(key, 6)
        self.q_proj = L.Linear(feat_dim, feat_dim, k[0])
        self.k_proj = L.Linear(text_dim, feat_dim, k[1])
        self.v_proj = L.Linear(text_dim, feat_dim, k[2])
        self.attn = MHA(feat_dim, k[3])
        self.out_mlp = nn.ModuleDict({"0": L.Linear(feat_dim, feat_dim, k[4]),
                                      "2": L.Linear(feat_dim, feat_dim, k[5])})
        self.norm_q = L.Norm(feat_dim)
        self.norm_out = L.Norm(feat_dim)


class DecoderLayer(nn.Module):
    def __init__(self, cin: int, cout: int, freq: bool, last: bool, key=None):
        super().__init__()
        self.conv = (L.ConvTranspose2d(cin, cout, (8, 1), key) if freq
                     else L.ConvTranspose1d(cin, cout, 8, key))
        if not last:
            self.norm = L.Norm(cout)


class Decoder(nn.Module):
    """The JAX ``_decoder_init``: ``key, k = split(key)`` per layer."""

    def __init__(self, freq: bool, chans=tuple(DECODER_CHANNELS), key=None):
        super().__init__()
        n = len(chans) - 1
        layers = []
        for i in range(n):
            key, k = L.split(key)
            layers.append(DecoderLayer(chans[i], chans[i + 1], freq,
                                       i == n - 1, k))
        self.layers = nn.ModuleList(layers)


class Head(nn.Module):
    """Trainable head: cross-attention + decoders + output convs (~3 M);
    keys as the JAX ``head_init``: ``split(key, 5)`` in that order."""

    def __init__(self, decoder_channels=tuple(DECODER_CHANNELS),
                 text_dim: int = TEXT_DIM, key=None):
        super().__init__()
        chans = tuple(decoder_channels)
        k = L.split(key, 5)
        self.text_attn = TextCrossAttention(chans[0], text_dim, k[0])
        self.freq_decoder = Decoder(True, chans, k[1])
        self.time_decoder = Decoder(False, chans, k[2])
        self.freq_out = L.Conv2d(chans[-1], 2, (1, 1), k[3])
        self.time_out = L.Conv1d(chans[-1], 2, 1, k[4])


class AudioTextHTDemucs(nn.Module):
    def __init__(self, htdemucs_model: htdemucs.HTDemucs,
                 clap: clap_text.ClapText, head: Head):
        super().__init__()
        self.htdemucs = htdemucs_model
        self.clap = clap
        self.head = head
        self.requires_grad_(False)
        # True once converted reference weights are loaded (``load_params``
        # of a ``.pt``): the tokenizer then refuses the hash fallback
        self.pretrained = False


def _keys(seed: int, device, materialize: bool) -> list:
    """``split(PRNGKey(seed), 3)`` on ``device`` (towers, CLAP, head), as
    the JAX ``init`` / ``init_tiny`` split theirs; three Nones (no draws)
    without ``materialize``."""
    if not materialize:
        return [None] * 3
    return prng.split(prng.PRNGKey(seed, device), 3)


def init(seed: int = 0, materialize: bool = True,
         device: str | torch.device = "cpu") -> AudioTextHTDemucs:
    """The full-width model the JAX ``atht.init(jax.random.PRNGKey(seed))``
    builds, the same numbers (uniform leaves bit for bit, normal leaves
    within ``prng.NORMAL_RTOL``), drawn on ``device``.  Seed 0's towers are
    the ones the committed head was trained on.  ``materialize=False``
    skips the draws (storage uninitialised, on the CPU), for a model that
    is about to be loaded."""
    k1, k2, k3 = _keys(seed, device, materialize)
    model = AudioTextHTDemucs(htdemucs.HTDemucs(key=k1),
                              clap_text.ClapText(key=k2), Head(key=k3))
    return model.to(device) if materialize else model


def init_tiny(seed: int = 0, materialize: bool = True,
              device: str | torch.device = "cpu") -> AudioTextHTDemucs:
    """The JAX ``atht.init_tiny(jax.random.PRNGKey(seed))``: full wiring at
    ~1/100 of the width, for tests, with the same numbers as ``init``."""
    k1, k2, k3 = _keys(seed, device, materialize)
    model = AudioTextHTDemucs(
        htdemucs.HTDemucs(channels=(8, 16, 24, 32), bottom_channels=64,
                          t_layers=2, key=k1),
        clap_text.ClapText(num_layers=2, hidden=128, key=k2),
        Head(decoder_channels=(32, 16, 8, 8, 4), key=k3))
    return model.to(device) if materialize else model


def init_from_env(seed: int = 0, device: str | torch.device = "cpu"
                  ) -> AudioTextHTDemucs:
    """``init_tiny`` under ``ATSM_TINY_MODEL=1`` (command-line runs at test
    size), else ``init``: the JAX ``atht.init_from_env``."""
    if os.environ.get("ATSM_TINY_MODEL") == "1":
        return init_tiny(seed, device=device)
    return init(seed, device=device)


def load_from_env(checkpoint: str | Path | None = None, seed: int = 0,
                  device: str | torch.device = "cpu") -> AudioTextHTDemucs:
    """The commands' model: ``init_from_env`` (drawn on ``device``) with
    ``checkpoint`` (or the committed trained head) loaded by
    ``load_params``.  A test-size model without a checkpoint keeps its
    random head, since the committed head is full width, as in the JAX
    package."""
    model = init_from_env(seed, device)
    if checkpoint or os.environ.get("ATSM_TINY_MODEL") != "1":
        load_params(model, checkpoint)
    return model


def graft_head(model: AudioTextHTDemucs, path: str | Path = DEFAULT_HEAD
               ) -> AudioTextHTDemucs:
    """Load a head saved by the JAX ``save_params_npz`` (e.g. the committed
    ``artifacts/trained_head.npz``) into ``model.head``, strictly."""
    jax_params.load_npz(model.head, path, prefix=("head",))
    return model


def load_params(model: AudioTextHTDemucs, checkpoint: str | Path | None = None
                ) -> AudioTextHTDemucs:
    """The commands' one checkpoint loader, the JAX ``atht.load_params``:

    - no checkpoint: graft the committed trained head;
    - ``*.pt``: a reference ``AudioTextHTDemucs`` checkpoint, converted
      (``convert.torch_import``, CLAP non-strict as the JAX loader does);
      the model is then marked ``pretrained``, so a ``Separator`` built on
      it refuses the hash-tokenizer fallback;
    - ``*.npz``: the whole param tree (JAX ``save_params_npz`` of
      ``atht.init`` params), strictly;
    - a directory: a checkpoint the port's trainer wrote
      (``train/checkpoint.py``), whose head is loaded strictly.
    """
    if checkpoint is None:
        return graft_head(model)
    path = Path(checkpoint)
    if path.suffix == ".pt":
        from ..convert.torch_import import import_atht_checkpoint

        import_atht_checkpoint(path, strict=False, model=model)
        model.pretrained = True
    elif path.is_dir():
        from ..train.checkpoint import load_head

        load_head(path, model.head)
    elif path.suffix == ".npz":
        model.load_state_dict(jax_params.state_dict_from_npz(path),
                              strict=True)
    else:
        raise ValueError(f"unsupported checkpoint {checkpoint!r}: expected "
                         ".pt, .npz or a training checkpoint directory")
    return model


# ---------------------------------------------------------------------------
# Text cross-attention and decoders
# ---------------------------------------------------------------------------

def _attend_single_token(p: TextCrossAttention, queries: torch.Tensor,
                         text_emb: torch.Tensor) -> torch.Tensor:
    """forward_attend with a 1-token memory: the attention weights are
    exactly 1, so the MHA output is ``out_proj(V)`` broadcast to every query.

    queries: (B, L, C); text_emb: (B, text_dim).
    """
    e = queries.shape[-1]
    dt = queries.dtype
    v = L.linear(p.v_proj, text_emb.to(dt))                         # (B, C)
    w = p.attn.in_proj_weight.to(dt)
    b = p.attn.in_proj_bias.to(dt)
    v = v @ w[2 * e:].T + b[2 * e:]
    op = p.attn.out_proj
    attn_out = v @ op.weight.to(dt).T + op.bias.to(dt)               # (B, C)
    out = queries + attn_out[:, None, :]
    h = L.gelu(L.linear(p.out_mlp["0"], out))
    out = out + L.linear(p.out_mlp["2"], h)
    return L.layer_norm(p.norm_out, out)


def text_cross_attention_apply(p: TextCrossAttention, x: torch.Tensor,
                               xt: torch.Tensor, text_emb: torch.Tensor):
    """x: (B, C, F, T) freq feats, xt: (B, C, T), text_emb: (B, text_dim)."""
    b, c, f, t = x.shape
    x_seq = x.reshape(b, c, f * t).transpose(1, 2)
    xt_seq = xt.transpose(1, 2)
    x_seq = _attend_single_token(p, x_seq, text_emb)
    xt_seq = _attend_single_token(p, xt_seq, text_emb)
    return (x_seq.transpose(1, 2).reshape(b, c, f, t), xt_seq.transpose(1, 2))


def _join(layer: DecoderLayer, x: torch.Tensor, size: int,
          skip: torch.Tensor) -> torch.Tensor:
    """What follows a decoder layer's transposed convolution: its
    GroupNorm(1) and GELU (the last layer has none), axis 2 resized to
    ``size``, and the skip's first C channels, resized likewise, added at
    ``SKIP_SCALE``.

    Where autograd records (the head's training step) it is the chain of
    ops it always was, since the fused join has no backward: the norm
    (through ``GroupNormFunction`` on the card), then
    ``ops.fused_norm.decoder_join_plain``'s resizes and skip add; otherwise
    ``ops.fused_norm.decoder_join``: on the card the norm's statistics and
    one launch that reads each tap of x and of the skip once and writes the
    output once, on the CPU the same chain op for op."""
    norm = getattr(layer, "norm", None)
    affine = (None, None) if norm is None else (norm.weight, norm.bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, skip, *affine)):
        if norm is not None:
            x = L.group_norm(norm, x, 1, act="gelu")
        return fused_norm.decoder_join_plain(x, None, None, skip, size,
                                             SKIP_SCALE)
    return fused_norm.decoder_join(x, *affine, skip, size, SKIP_SCALE)


def freq_decoder_apply(p: Decoder, x: torch.Tensor, skips: List[torch.Tensor],
                       target_lengths: List[int]) -> torch.Tensor:
    """4 x [ConvT2d k=(8,1) s=(4,1) p=(2,0) -> GroupNorm(1) -> GELU] with the
    frequency axis resized to ``target_lengths[i]`` and 0.1-scaled skips.

    Where F already equals the target, the resize is an exact /4 decimation
    (taps 4i+1 and 4i+2, each weighing 1/2); the JAX package fuses that
    case into ``_freq_layer_down4`` (an XLA lowering choice).  On the card
    the serving paths run each layer's join as one launch (``_join``), which
    reads only the rows those taps name; training keeps the plain chain."""
    for layer, size, skip in zip(p.layers, target_lengths, skips,
                                 strict=True):
        x = L.conv_transpose2d(layer.conv, x, stride=(4, 1), padding=(2, 0))
        x = _join(layer, x, size, skip)
    return x


def time_decoder_apply(p: Decoder, x: torch.Tensor, skips: List[torch.Tensor],
                       target_lengths: List[int]) -> torch.Tensor:
    """4 x [ConvT1d k=8 s=4 p=2 -> GroupNorm(1) -> GELU] with the sequence
    resized to ``target_lengths[i]`` and 0.1-scaled skips (``_join``)."""
    for layer, size, skip in zip(p.layers, target_lengths, skips,
                                 strict=True):
        x = L.conv_transpose1d(layer.conv, x, stride=4, padding=2)
        x = _join(layer, x, size, skip)
    return x


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def encode_text(model: AudioTextHTDemucs, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, normalize: bool = False
                ) -> torch.Tensor:
    """Frozen CLAP text embeddings (B, 512); ``normalize=True`` is
    ``ClapModel.get_text_features``.  Span ``atsm.model.text_tower``,
    counter ``text.tower_runs``."""
    fn = clap_text.get_text_features if normalize else clap_text.text_embeds
    profiling.count("text.tower_runs")
    with profiling.span("atsm.model.text_tower"):
        return fn(model.clap, input_ids, attention_mask)


def encode_mixture(model: AudioTextHTDemucs, wav: torch.Tensor,
                   compute_dtype: torch.dtype = torch.float32,
                   kernels: Kernels = True) -> Dict[str, Any]:
    """Text-independent half of the forward: f32 DSP front end, then the
    frozen encoder in ``compute_dtype``.  Multi-stem separation encodes once
    and reuses this state for every stem."""
    sel = resolve(kernels)
    z, mag, x, xt, mean, std, meant, stdt = htdemucs.normalize_inputs(
        wav.float(), sel.stft)
    x_enc, xt_enc, saved, saved_t, lengths, lengths_t = htdemucs.encode(
        model.htdemucs, x.to(compute_dtype), xt.to(compute_dtype), sel)
    return {
        "z": z, "mag": mag, "x_enc": x_enc, "xt_enc": xt_enc,
        "saved": saved, "saved_t": saved_t,
        "lengths": lengths, "lengths_t": lengths_t,
        "meant": meant, "stdt": stdt,
        "original_length": wav.shape[-1],
    }


def _expand(v: torch.Tensor, b: int) -> torch.Tensor:
    """Broadcast a batch-``b0`` tensor to batch ``b = k*b0`` (stem tiling)."""
    b0 = v.shape[0]
    if b0 == b:
        return v
    return v[None].expand(b // b0, *v.shape).reshape(b, *v.shape[1:])


def apply_head(model: AudioTextHTDemucs, enc: Dict[str, Any],
               text_emb: torch.Tensor) -> torch.Tensor:
    """Text-conditioned head: cross-attention + decoders + masking + iSTFT.
    Returns (B, 2, T) f32."""
    head = model.head
    original_length = enc["original_length"]
    fq, t_spec = enc["mag"].shape[-2:]

    x_cond, xt_cond = text_cross_attention_apply(
        head.text_attn, enc["x_enc"], enc["xt_enc"], text_emb)

    x_dec = freq_decoder_apply(head.freq_decoder, x_cond,
                               enc["saved"][::-1], enc["lengths"][::-1])
    x_dec = L.conv2d(head.freq_out, x_dec)
    x_dec = L.interpolate_bilinear(x_dec, (fq, t_spec)).float()

    mask = torch.sigmoid(x_dec)                        # (B, 2, F, T)
    b = mask.shape[0]
    mag_stereo = _expand(enc["mag"][:, :2], b)         # CaC re/im planes
    masked = mag_stereo * mask
    z_stereo = _expand(enc["z"][:, :2], b)
    # the reference's signed "magnitude": keep the exact algebra
    phase = z_stereo / (mag_stereo + 1e-8)
    masked_z = masked * phase
    freq_wav = dsp.ispec(masked_z, original_length, htdemucs.NFFT, htdemucs.HOP)

    xt_dec = time_decoder_apply(head.time_decoder, xt_cond,
                                enc["saved_t"][::-1], enc["lengths_t"][::-1])
    xt_dec = L.conv1d(head.time_out, xt_dec)
    if xt_dec.shape[-1] != original_length:
        xt_dec = L.interpolate_linear(xt_dec, original_length)
    xt_dec = (xt_dec.float() * _expand(enc["stdt"], b)
              + _expand(enc["meant"], b))
    return freq_wav + xt_dec


def apply_head_multi(model: AudioTextHTDemucs, enc: Dict[str, Any],
                     stem_embs: torch.Tensor, max_batch: int = 64
                     ) -> torch.Tensor:
    """The head for S stems as one batched pass -> (S, B, 2, T).

    Only the attention inputs are tiled S times; the stem-independent
    encoder state stays at batch B and is broadcast where it is used.
    Beyond ``max_batch`` combined rows the stems run one after another.
    """
    s = stem_embs.shape[0]
    b = enc["mag"].shape[0]
    if s * b > max_batch:
        return torch.stack([
            apply_head(model, enc, stem_embs[i][None].expand(b, -1))
            for i in range(s)])
    tiled = dict(enc)
    tiled["x_enc"] = torch.cat([enc["x_enc"]] * s, dim=0)
    tiled["xt_enc"] = torch.cat([enc["xt_enc"]] * s, dim=0)
    e = stem_embs.repeat_interleave(b, dim=0)            # (S*B, 512)
    out = apply_head(model, tiled, e)
    return out.reshape(s, b, 2, out.shape[-1])


def forward_with_text_emb(model: AudioTextHTDemucs, wav: torch.Tensor,
                          text_emb: torch.Tensor,
                          compute_dtype: torch.dtype = torch.float32,
                          kernels: Kernels = True) -> torch.Tensor:
    """(B, 2, T) mixture + (B, 512) text embedding -> (B, 2, T) stem."""
    enc = encode_mixture(model, wav, compute_dtype, kernels)
    return apply_head(model, enc, text_emb).to(wav.dtype)


def forward(model: AudioTextHTDemucs, wav: torch.Tensor,
            input_ids: torch.Tensor, attention_mask: torch.Tensor,
            compute_dtype: torch.dtype = torch.float32,
            kernels: Kernels = True, normalize_text: bool = False
            ) -> torch.Tensor:
    """Full forward: mixture + tokenised prompts -> separated stem.

    The frozen towers (text tower and encoder) run under
    ``torch.no_grad()``, as the JAX package stops their gradients; only the
    head records autograd, so a loss on the result differentiates the head
    alone."""
    with torch.no_grad():
        text_emb = encode_text(model, input_ids, attention_mask,
                               normalize_text)
        enc = encode_mixture(model, wav, compute_dtype, kernels)
    return apply_head(model, enc, text_emb).to(wav.dtype)
