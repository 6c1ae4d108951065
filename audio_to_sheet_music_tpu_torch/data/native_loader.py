"""ctypes binding of the C++ segment loader (``native/segment_loader.cpp``).

Counterpart of ``audio_to_sheet_music_tpu/data/native_loader.py``, with its
own copy of the source.  The library is built with ``g++ -O3 -std=c++17
-shared -fPIC -pthread`` at first use into ``build/native/`` at the
repository root, named by a hash of the source and the flags; the compiler
writes a per-process temporary file that is renamed into place, so a
concurrent first use in another process never opens a half-written
library.  A build that fails raises: the trainer asked for this loader
(``training.num_workers >= 1``) and does not quietly take the Python one.

``NativeBatchLoader`` has the iterator contract of the Python
``BatchLoader``: batches of ``{mixture, target, input_ids, attention_mask,
stem_index}`` as host numpy arrays.  Tokenisation stays in Python (one
table of every prompt variant, tokenised once); segment slicing,
augmentation and batching run in C++ worker threads over the mmapped
``.npy`` track caches.  Each sample's random draws come from its own index,
so a batch is the same for any thread count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Sequence

import numpy as np

from ..text.prompts import STEM_NAMES, STEM_PROMPTS

SOURCE = Path(__file__).resolve().parent / "native" / "segment_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
COMPILER = "g++"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LOCK = threading.Lock()
_LIBS: Dict[Path, ctypes.CDLL] = {}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join([COMPILER] + FLAGS).encode())
    return BUILD_DIR / f"libsegment_loader-{digest.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sl_create.restype = ctypes.c_void_p
    lib.sl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
        ctypes.c_int, ctypes.c_ulong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.sl_epoch_size.restype = ctypes.c_long
    lib.sl_epoch_size.argtypes = [ctypes.c_void_p]
    lib.sl_next.restype = ctypes.c_int
    lib.sl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_int32)]
    lib.sl_reset.argtypes = [ctypes.c_void_p, ctypes.c_ulong]
    lib.sl_track_count.restype = ctypes.c_long
    lib.sl_track_count.argtypes = [ctypes.c_void_p]
    lib.sl_destroy.argtypes = [ctypes.c_void_p]
    return lib


def load_library() -> ctypes.CDLL:
    """The bound library, built first if it is not in ``BUILD_DIR``;
    raises ``RuntimeError`` when the build fails."""
    target = library_path()
    with _LOCK:
        if target in _LIBS:
            return _LIBS[target]
        if not target.exists():
            target.parent.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
            try:
                out = subprocess.run([COMPILER, *FLAGS, str(SOURCE), "-o",
                                      str(tmp)], capture_output=True,
                                     text=True)
            except OSError as e:
                raise RuntimeError(f"segment loader: cannot run {COMPILER}: "
                                   f"{e}") from e
            if out.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"segment loader: {COMPILER} failed ({out.returncode}):\n"
                    f"{out.stderr[-2000:]}")
            os.replace(tmp, target)
        _LIBS[target] = _bind(ctypes.CDLL(str(target)))
        return _LIBS[target]


class NativeBatchLoader:
    """C++-backed batch iterator over decode-once ``.npy`` track caches."""

    def __init__(self, track_paths: Sequence[str | Path], segment_samples: int,
                 batch_size: int, tokenizer, seed: int = 0,
                 n_threads: int = 4, augment: bool = False,
                 random_segments: bool = False, max_token_len: int = 16):
        lib = load_library()
        self._lib = lib
        self._h = None
        self.segment = int(segment_samples)
        self.batch = int(batch_size)
        self.max_token_len = max_token_len
        self._epoch = 0
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        paths = [str(p).encode() for p in track_paths]
        arr = (ctypes.c_char_p * len(paths))(*paths)
        self._h = lib.sl_create(arr, len(paths), self.segment, self.batch,
                                seed, n_threads, int(augment),
                                int(random_segments))
        loaded = int(lib.sl_track_count(self._h))
        if loaded < len(paths):
            lib.sl_destroy(self._h)
            self._h = None
            raise RuntimeError(
                f"native loader parsed only {loaded}/{len(paths)} track "
                "caches (corrupt or truncated .npy? see stderr for names)")
        self._n_batches = int(lib.sl_epoch_size(self._h))
        prompts = [p for ps in STEM_PROMPTS.values() for p in ps]
        ids, mask = tokenizer(prompts)
        w = min(max_token_len, ids.shape[1])
        self._tok_ids = np.full((len(prompts), max_token_len), 1, np.int32)
        self._tok_mask = np.zeros((len(prompts), max_token_len), np.int32)
        self._tok_ids[:, :w] = ids[:, :w]
        self._tok_mask[:, :w] = mask[:, :w]
        self._prompt_slices = {}
        off = 0
        for stem, ps in STEM_PROMPTS.items():
            self._prompt_slices[stem] = (off, off + len(ps))
            off += len(ps)

    def __len__(self) -> int:
        return self._n_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._epoch > 0:
            self._lib.sl_reset(self._h, self._seed + self._epoch)
        self._epoch += 1
        b, seg = self.batch, self.segment
        f32 = ctypes.POINTER(ctypes.c_float)
        while True:
            mix = np.empty((b, 2, seg), np.float32)
            tgt = np.empty((b, 2, seg), np.float32)
            sidx = np.empty((b,), np.int32)
            if not self._lib.sl_next(
                    self._h, mix.ctypes.data_as(f32),
                    tgt.ctypes.data_as(f32),
                    sidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))):
                break
            ids = np.empty((b, self.max_token_len), np.int32)
            mask = np.empty((b, self.max_token_len), np.int32)
            for i, s in enumerate(sidx):
                lo, hi = self._prompt_slices[STEM_NAMES[int(s)]]
                j = int(self._rng.integers(lo, hi))
                ids[i] = self._tok_ids[j]
                mask[i] = self._tok_mask[j]
            yield {"mixture": mix, "target": tgt, "input_ids": ids,
                   "attention_mask": mask, "stem_index": sidx}

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sl_destroy(self._h)
            self._h = None
