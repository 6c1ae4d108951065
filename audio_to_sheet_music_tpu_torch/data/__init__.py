"""Host-side data pipeline: MusDB18 tracks, segment dataset, prefetch."""

from .musdb import (  # noqa: F401
    BatchLoader,
    StemSegmentDataset,
    Track,
    build_cache,
    discover_tracks,
)
from .synth import synthetic_tracks  # noqa: F401
