"""The training batches, cut again from the tracks' raw npy files.

A frozen copy of the sampling plan of the port's ``data.musdb`` loader
(``StemSegmentDataset`` with random segments and augmentation, shuffled
each epoch by ``BatchLoader``, whole batches only): for every sample the
same track, stem, start, joint gain, channel swap and prompt, drawn in the
same order from numpy generators seeded as the loader's are.  The
reference reads the tracks itself, so it never takes the loader's output.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from . import text

STEM_NAMES = ("drums", "bass", "other", "vocals")
STEM_PROMPTS = {
    "drums": ["drums", "drum kit", "percussion", "the drums"],
    "bass": ["bass", "bass guitar", "the bass", "bass line"],
    "other": ["other instruments", "accompaniment", "instruments"],
    "vocals": ["vocals", "voice", "singing", "the vocals"],
}
MAX_TOKENS = 16


def plan(lengths: Sequence[int], segment: int, batch: int, seed: int,
         n_batches: int) -> List[List[Dict]]:
    """The first ``n_batches`` batches' samples (``track``, ``stem``,
    ``start``, ``gain`` or None, ``swap``, ``prompt``) for tracks of
    ``lengths`` samples."""
    index = [(fi, stem, seg) for fi, t in enumerate(lengths)
             for stem in STEM_NAMES
             for seg in range(max(1, math.ceil(t / segment)))]
    draw = np.random.default_rng(seed)       # the dataset's generator
    shuffle = np.random.default_rng(seed)    # the loader's
    per_epoch = len(index) // batch
    out: List[List[Dict]] = []
    while len(out) < n_batches:
        order = np.arange(len(index))
        shuffle.shuffle(order)
        for b in range(per_epoch):
            if len(out) == n_batches:
                break
            items = []
            for idx in order[b * batch:(b + 1) * batch]:
                fi, stem, seg = index[int(idx)]
                t = lengths[fi]
                if t > segment:
                    start = int(draw.integers(0, t - segment + 1))
                else:
                    start = min(seg * segment, max(0, t - 1))
                gain = draw.uniform(0.7, 1.3) if draw.random() < 0.5 else None
                swap = bool(draw.random() < 0.3)
                names = STEM_PROMPTS[stem]
                items.append({"track": fi, "stem": stem, "start": start,
                              "gain": gain, "swap": swap,
                              "prompt": names[int(draw.integers(len(names)))]})
            out.append(items)
    return out


def _cut(arr: np.ndarray, start: int, segment: int) -> np.ndarray:
    seg = np.asarray(arr[..., start:start + segment], np.float32)
    if seg.shape[-1] < segment:
        seg = np.pad(seg, [(0, 0)] * (seg.ndim - 1)
                     + [(0, segment - seg.shape[-1])])
    return seg


def cut(items: List[Dict], tracks: Sequence[np.ndarray], segment: int
        ) -> Dict[str, np.ndarray]:
    """One batch from ``tracks`` ((5, 2, T): the mixture, then the stems in
    ``STEM_NAMES`` order): mixture, target, input_ids, attention_mask."""
    mixes, targets = [], []
    for it in items:
        arr = tracks[it["track"]]
        mix = _cut(arr[0], it["start"], segment)
        tgt = _cut(arr[1 + STEM_NAMES.index(it["stem"])], it["start"], segment)
        if it["gain"] is not None:
            mix, tgt = mix * it["gain"], tgt * it["gain"]
        if it["swap"]:
            mix, tgt = mix[::-1].copy(), tgt[::-1].copy()
        mixes.append(mix)
        targets.append(tgt)
    ids, mask = text.fit(*text.tokenize([it["prompt"] for it in items]),
                         MAX_TOKENS)
    return {"mixture": np.stack(mixes), "target": np.stack(targets),
            "input_ids": ids, "attention_mask": mask}
