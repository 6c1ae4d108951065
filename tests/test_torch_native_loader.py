"""The port's C++ segment loader against the JAX package's (CPU, g++).

- For the same tracks, seed and thread count, the port's
  ``NativeBatchLoader`` and the JAX one give identical batches (arrays,
  stems, prompt ids) over two epochs, plain and augmented; the count of
  worker threads does not change a batch.
- Every served segment is an exact slice of its track (as the JAX
  ``tests/test_native_loader.py`` checks).
- A failing compiler raises instead of leaving the caller on the Python
  loader, and ``train`` with ``num_workers >= 1`` runs on this loader.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from audio_to_sheet_music_tpu.data.native_loader import \
    NativeBatchLoader as JaxLoader
from audio_to_sheet_music_tpu_torch import config as TC
from audio_to_sheet_music_tpu_torch.data import native_loader, synthetic_tracks
from audio_to_sheet_music_tpu_torch.models import atht as TA
from audio_to_sheet_music_tpu_torch.text.tokenizer import HashTokenizer

SEG = 22050


@pytest.fixture(scope="module")
def tracks(tmp_path_factory):
    return synthetic_tracks(2, seconds=3.0,
                            cache_dir=tmp_path_factory.mktemp("native"))


def _epochs(loader, n=2):
    return [[{k: v.copy() for k, v in b.items()} for b in loader]
            for _ in range(n)]


def _same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb) > 0
        for x, y in zip(ea, eb):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("augment", [False, True])
def test_batches_equal_the_jax_loader(tracks, augment):
    kw = dict(segment_samples=SEG, batch_size=4, tokenizer=HashTokenizer(),
              seed=5, n_threads=3, augment=augment, random_segments=augment)
    paths = [t.path for t in tracks]
    port = _epochs(native_loader.NativeBatchLoader(paths, **kw))
    _same(port, _epochs(JaxLoader(paths, **kw)))
    kw["n_threads"] = 1
    _same(port, _epochs(native_loader.NativeBatchLoader(paths, **kw)))


def test_segments_match_source_arrays(tracks):
    loader = native_loader.NativeBatchLoader(
        [t.path for t in tracks], SEG, 4, HashTokenizer(), n_threads=2)
    arrs = [t.load(mmap=False) for t in tracks]
    n = 0
    for batch in loader:
        for i in range(4):
            mix, tgt = batch["mixture"][i], batch["target"][i]
            stem = int(batch["stem_index"][i]) + 1
            hits = [(arr, s) for arr in arrs
                    for s in range(0, arr.shape[-1], SEG)
                    if np.array_equal(mix[:, :min(SEG, arr.shape[-1] - s)],
                                      arr[0, :, s:s + SEG])]
            assert hits, f"sample {n} is not a segment of a track"
            arr, s = hits[0]
            np.testing.assert_array_equal(tgt[:, :arr.shape[-1] - s],
                                          arr[stem, :, s:s + SEG])
            n += 1
    assert n >= 8


def test_a_failed_build_raises(tracks, tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_loader, "COMPILER", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native_loader.NativeBatchLoader([t.path for t in tracks], SEG, 4,
                                        HashTokenizer())
    monkeypatch.setattr(native_loader, "COMPILER", str(tmp_path / "no-g++"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native_loader.load_library()
    assert not list((tmp_path / "native").glob("*.so"))


def test_library_is_built_once_per_source(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "native")
    assert not native_loader.library_path().exists()
    lib = native_loader.load_library()
    assert native_loader.library_path().exists()
    assert native_loader.load_library() is lib


def test_train_takes_the_native_loader(tracks, tmp_path, monkeypatch):
    from audio_to_sheet_music_tpu_torch.train import trainer

    made = []
    real = trainer.NativeBatchLoader

    def spy(*a, **kw):
        made.append(kw["n_threads"])
        return real(*a, **kw)

    monkeypatch.setattr(trainer, "NativeBatchLoader", spy)
    root = tracks[0].path.parent
    cfg = TC.Config(
        data=TC.DataConfig(train_dir=str(root), test_dir=str(root),
                           segment_seconds=0.25),
        model=TC.ModelConfig(compute_dtype="float32"),
        training=TC.TrainingConfig(batch_size=2, num_epochs=1, num_workers=2),
        wandb=TC.WandbConfig(log_every=1, validate_every=5,
                             checkpoint_dir=str(tmp_path / "ckpt"),
                             output_dir=str(tmp_path / "out")))
    result = trainer.train(cfg, model=TA.init_tiny(0), max_steps_per_epoch=2,
                           device="cpu", kernels=False)
    assert made == [2] and np.isfinite(result["final_loss"])
    # a percentage subset keeps the Python loader, as in the JAX trainer
    made.clear()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, pct_train=0.5))
    trainer.train(cfg, model=TA.init_tiny(0), max_steps_per_epoch=1,
                  device="cpu", kernels=False)
    assert made == []
