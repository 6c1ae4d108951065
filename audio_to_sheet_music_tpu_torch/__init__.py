"""audio_to_sheet_music_tpu_torch — the PyTorch + CUDA port for NVIDIA Hopper.

Text-conditioned music stem separation (AudioTextHTDemucs) in PyTorch, with
the serving path's hand-written kernels in CUDA C++ for ``sm_90a``.  The JAX
package ``audio_to_sheet_music_tpu`` beside it is the reference this package
is tested against; nothing here imports it or JAX.

Subpackages mirror the JAX layout, so each module's counterpart sits under
the same path:

- ``text``    — prompt templates and the tokenizer (hash fallback).
- ``convert`` — JAX param pytree / ``.npz`` -> ``state_dict`` bridge.
- ``nn``      — layer modules with the torch checkpoint names, plain ops.
- ``ops``     — DSP front/back end and the two fused kernels
  (``fused_attn.layer_tail``, ``fused_enc.henc_freq_fused``) with their
  plain PyTorch versions and the ``nvcc`` build helper.
- ``models``  — HTDemucs encode path, the CLAP text tower, AudioTextHTDemucs.
- ``infer``   — chunk planning, overlap-add, the ``Separator`` session and
  the ``StreamingSeparator``.
- ``utils``   — WAV IO, spectrogram plots (matplotlib, imported when
  drawing) and timing helpers.
- ``apps``    — the ``separate`` and spectrogram commands, the stdlib HTTP
  server and the ``serve`` app.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
