from gigalens_tpu_torch.utils.checkpoint import PipelineCheckpointer
from gigalens_tpu_torch.utils.diagnostics import (
    effective_sample_size,
    potential_scale_reduction,
)
from gigalens_tpu_torch.utils.images import find_images
from gigalens_tpu_torch.utils.profiling import PhaseTimer, timed, trace
from gigalens_tpu_torch.utils.summary import format_summary, summarize_posterior

__all__ = [
    "PipelineCheckpointer",
    "PhaseTimer",
    "timed",
    "trace",
    "effective_sample_size",
    "potential_scale_reduction",
    "summarize_posterior",
    "format_summary",
    "find_images",
]
