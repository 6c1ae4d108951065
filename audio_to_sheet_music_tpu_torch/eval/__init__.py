"""Separation benchmark harness (the reference ``benchmark.py`` protocol)."""

from .harness import (  # noqa: F401
    TrackResult,
    aggregate_results,
    compute_metrics,
    compute_sdr,
    compute_sisdr,
    evaluate_model,
    evaluate_model_on_track,
    format_results_table,
    save_results,
)
from .models import (  # noqa: F401
    HTDemucsBaseline,
    OursModel,
    SeparationModel,
)
