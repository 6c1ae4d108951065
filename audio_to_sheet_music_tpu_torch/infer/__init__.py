"""Full-song inference: chunk planning, overlap-add, the Separator and the
streaming separator."""

from .chunked import (  # noqa: F401
    ChunkGrid,
    fade_weights,
    frame_song,
    overlap_add_weighted,
    plan_chunks,
    separate_chunked,
)
from .session import Separator  # noqa: F401
from .streaming import StreamingSeparator  # noqa: F401
