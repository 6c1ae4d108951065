"""The port's learning proof against the JAX package's loop (CPU, tiny).

``apps.learning_proof.run`` at ``ATSM_TINY_MODEL=1`` (the tiny seed-0
model with its random head), a few steps on short tracks: its SDR before
training must equal the JAX loop's (``scripts/learning_proof.py``: the JAX
``OursModel`` over ``atht.init_tiny(PRNGKey(0))``, 6 s segments, 1.5 s
overlap, on the same seed-99 test track) to 1e-3 dB a stem.  No weights
move between the packages: the port draws its own seed-0 model.  The JAX
side serves through its default int16 wire, which moves an SDR near 0 dB
by ~1e-6 dB.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from audio_to_sheet_music_tpu.data import synthetic_tracks as jax_tracks
from audio_to_sheet_music_tpu.eval import aggregate_results, evaluate_model
from audio_to_sheet_music_tpu.eval.models import OursModel as JaxOurs
from audio_to_sheet_music_tpu.models import atht as JA
from audio_to_sheet_music_tpu_torch.apps import learning_proof
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.train.checkpoint import load_params_npz

SIZE = dict(batch=2, segment_seconds=0.5, train_seconds=2.0, test_seconds=6.0)


@pytest.fixture(scope="module")
def proof(tmp_path_factory):
    root = tmp_path_factory.mktemp("proof")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ATSM_TINY_MODEL", "1")
        res = learning_proof.run(steps=2, device="cpu", data_dir=root,
                                 save=root / "head.npz", **SIZE)
    return res, root


def test_before_matches_the_jax_loop(proof, tmp_path):
    res, _ = proof
    test = jax_tracks(1, seconds=SIZE["test_seconds"], cache_dir=tmp_path,
                      seed=99)
    ours = JaxOurs(JA.init_tiny(jax.random.PRNGKey(0)), segment_seconds=6.0,
                   overlap_seconds=1.5)
    want = aggregate_results(evaluate_model(ours.separate_all, test, "jax",
                                            verbose=False))["sdr"]
    assert abs(res["before_db"] - want["average"]) < 1e-3
    for stem in learning_proof.STEMS:
        assert abs(res["before"][stem] - want[stem]) < 1e-3, stem


def test_trains_the_head_and_saves_it(proof):
    res, root = proof
    assert res["steps"] == 2 and res["steps_per_s"] > 0
    assert np.isfinite(res["after_db"]) and res["card"] is None
    assert res["after_db"] != res["before_db"]
    head = TA.init_tiny(0).head
    before = {k: v.clone() for k, v in head.state_dict().items()}
    load_params_npz(root / "head.npz", head)
    assert any(not np.array_equal(v.numpy(), before[k].numpy())
               for k, v in head.state_dict().items())


def test_main_prints_one_json_line(monkeypatch, capsys):
    seen = {}

    def fake_run(steps, device, kernels, batch, segment_seconds, save=None):
        seen.update(steps=steps, device=device, kernels=kernels, batch=batch)
        return {"before_db": -4.0, "after_db": 5.0, "improvement_db": 9.0,
                "steps": steps}

    monkeypatch.setattr(learning_proof, "run", fake_run)
    learning_proof.main(["--steps", "3", "--device", "cpu", "--kernels",
                         "none"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["steps"] == 3
    assert seen == {"steps": 3, "device": "cpu", "kernels": "none",
                    "batch": 8}
