"""Framework layer: processor protocol + batch orchestration.

Public API parity with the reference ``audio_processing_framework`` /
``processors`` modules, plus a batched device execution path: processors
that implement ``run_batch`` get whole padded ``(B, N)`` batches in one
device program instead of per-file process-pool calls.
"""

from audio_processing_tools_tpu.framework.processor import (
    AudioProcessor,
    BaseProcessor,
    RainProcessor,
    NoiseProcessor,
    has_processor,
)
from audio_processing_tools_tpu.framework.batch import (
    process_audio_batches_v2,
    process_audio_batches,
    restore_state_df_from_parquet,
)

__all__ = [
    "AudioProcessor",
    "BaseProcessor",
    "RainProcessor",
    "NoiseProcessor",
    "has_processor",
    "process_audio_batches_v2",
    "process_audio_batches",
    "restore_state_df_from_parquet",
]
