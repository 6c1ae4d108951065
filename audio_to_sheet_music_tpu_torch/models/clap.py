"""The whole CLAP model: text and audio towers and the contrastive head.

Counterpart of ``audio_to_sheet_music_tpu/models/clap.py``:
``get_text_features`` / ``get_audio_features`` (both L2-normalised) and the
contrastive logits with the learned temperatures ``logit_scale_t`` /
``logit_scale_a`` (HF ``ClapModel.forward``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from . import clap_audio, clap_text

LOGIT_SCALE_INIT = math.log(1 / 0.07)   # HF ClapConfig.logit_scale_init_value


class Clap(nn.Module):
    """``text`` and ``audio`` default to the full-width towers."""

    def __init__(self, text: clap_text.ClapText | None = None,
                 audio: clap_audio.ClapAudio | None = None, gen=None):
        super().__init__()
        self.text = text if text is not None else clap_text.ClapText(gen=gen)
        self.audio = (audio if audio is not None
                      else clap_audio.ClapAudio(gen=gen))
        self.logit_scale_t = nn.Parameter(torch.tensor(LOGIT_SCALE_INIT))
        self.logit_scale_a = nn.Parameter(torch.tensor(LOGIT_SCALE_INIT))


def get_text_features(p: Clap, input_ids, attention_mask) -> torch.Tensor:
    return clap_text.get_text_features(p.text, input_ids, attention_mask)


def get_audio_features(p: Clap, input_features) -> torch.Tensor:
    return clap_audio.get_audio_features(p.audio, input_features)


def similarity(p: Clap, input_ids, attention_mask, input_features
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ``(logits_per_audio (A, T), logits_per_text (T, A))``."""
    text = get_text_features(p, input_ids, attention_mask)
    audio = get_audio_features(p, input_features)
    logits_per_text = (text @ audio.T) * torch.exp(p.logit_scale_t)
    logits_per_audio = (audio @ text.T) * torch.exp(p.logit_scale_a)
    return logits_per_audio, logits_per_text
