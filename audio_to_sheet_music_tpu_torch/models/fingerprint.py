"""The seed-0 full-width model's fingerprint, held against the JAX package's.

``seed0_fingerprint.json`` (beside this module) holds, for every leaf of
``atht.init(0)``'s ``state_dict`` under its torch name, the count, the f64
sum and the f64 sum of squares of the JAX package's
``atht.init(jax.random.PRNGKey(0))``, and for every leaf that is not a
normal draw the SHA-256 of its little-endian f32 bytes.  The normal leaves
(the CLAP text tower's three embedding tables and the HTDemucs frequency
embedding, ``NORMAL_LEAVES``) carry no hash: their values are ulps from
JAX's (``nn.prng.NORMAL_RTOL``).  ``tests/test_torch_seeded_init.py``
holds the file to the JAX package; ``chip_smoke.py`` holds the model drawn
on the card to the file.
"""

from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path
from typing import Dict, Mapping

import torch

from ..nn import prng

PATH = Path(__file__).with_name("seed0_fingerprint.json")
NORMAL_LEAVES = ("htdemucs.freq_emb.embedding.weight",
                 "clap.embeddings.word_embeddings.weight",
                 "clap.embeddings.position_embeddings.weight",
                 "clap.embeddings.token_type_embeddings.weight")
# a sum over the same f32 values in another order (f64 accumulators)
SUM_RTOL = 1e-9


def leaf_print(name: str, t: torch.Tensor) -> Dict[str, object]:
    x = t.detach().double()
    out: Dict[str, object] = {"count": t.numel(), "sum": float(x.sum()),
                              "sumsq": float((x * x).sum())}
    if name not in NORMAL_LEAVES:
        data = t.detach().float().contiguous().cpu().numpy().tobytes()
        out["sha256"] = hashlib.sha256(data).hexdigest()
    return out


def fingerprint(state: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    return {k: leaf_print(k, v) for k, v in state.items()}


def load() -> Dict[str, dict]:
    return json.loads(PATH.read_text())


def mismatches(got: Mapping[str, dict], want: Mapping[str, dict]) -> list:
    """The leaves where ``got`` differs from ``want``: a missing or extra
    leaf, a count, a hash, or a sum beyond its tolerance.  The sums'
    tolerance is ``rtol * sqrt(count * sumsq)`` (a bound on the sum of
    ``rtol * |x|``), with ``rtol`` ``NORMAL_RTOL`` for a normal leaf and
    ``SUM_RTOL`` for a hashed one."""
    bad = [f"{k}: missing" for k in want if k not in got]
    bad += [f"{k}: not in the JAX tree" for k in got if k not in want]
    for k in sorted(set(got) & set(want)):
        g, w = got[k], want[k]
        if g["count"] != w["count"] or g.get("sha256") != w.get("sha256"):
            bad.append(f"{k}: count or hash differs")
            continue
        rtol = SUM_RTOL if "sha256" in w else prng.NORMAL_RTOL
        scale = math.sqrt(w["count"] * w["sumsq"])
        if (abs(g["sum"] - w["sum"]) > rtol * scale
                or abs(g["sumsq"] - w["sumsq"]) > 2 * rtol * w["sumsq"]):
            bad.append(f"{k}: sum {g['sum']!r} / {w['sum']!r}, sumsq "
                       f"{g['sumsq']!r} / {w['sumsq']!r}")
    return bad
