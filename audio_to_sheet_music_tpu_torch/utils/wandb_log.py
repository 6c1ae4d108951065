"""Weights & Biases media logging: the counterpart of
``audio_to_sheet_music_tpu/utils/wandb_log.py``.

Figure -> ``wandb.Image``, waveform -> ``wandb.Audio``, and the separation
triptych (mixture / target / estimate spectrograms and the three clips)
that the trainer logs.  The JAX module's single-spectrogram and all-stems
loggers are not carried over: nothing calls them.  Spectrograms are
computed on ``device`` (the card unless the caller asks for the CPU) by
``utils.plotting``.  Every function is a no-op when no wandb run is active; when ``wandb`` does not import it
says so on one line and logs nothing.
"""

from __future__ import annotations

import numpy as np


def _wandb():
    """The ``wandb`` module when a run is active, else ``None``."""
    try:
        import wandb
    except ImportError:
        print("wandb_log: wandb is not installed; media are not logged",
              flush=True)
        return None
    return wandb if wandb.run is not None else None


def _log_figure(wb, key: str, fig, step: int | None) -> None:
    import matplotlib.pyplot as plt

    wb.log({key: wb.Image(fig)}, step=step)
    plt.close(fig)


def log_audio_to_wandb(wav: np.ndarray, key: str, step: int | None = None,
                       sr: int = 44100) -> None:
    wb = _wandb()
    if wb is None:
        return
    wb.log({key: wb.Audio(np.asarray(wav, np.float32).T, sample_rate=sr)},
           step=step)


def log_separation_to_wandb(mixture: np.ndarray, target: np.ndarray,
                            estimate: np.ndarray, stem: str,
                            step: int | None = None,
                            prefix: str = "separation", device="cuda") -> None:
    """The triptych's spectrograms, then the three audio clips."""
    wb = _wandb()
    if wb is None:
        return
    from . import plotting

    fig = plotting.plot_separation_comparison(mixture, target, estimate, stem,
                                              device=device)
    _log_figure(wb, f"{prefix}/{stem}/spectrograms", fig, step)
    for name, wav in (("mixture", mixture), ("target", target),
                      ("estimate", estimate)):
        log_audio_to_wandb(wav, f"{prefix}/{stem}/{name}", step)
