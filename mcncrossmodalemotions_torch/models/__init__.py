"""models subpackage."""

from mcncrossmodalemotions_torch.models.pipeline import AudioStudentPipeline
from mcncrossmodalemotions_torch.models.vggm import (
    VGGMStudent,
    temporal_valid_frames,
)

__all__ = ["AudioStudentPipeline", "VGGMStudent", "temporal_valid_frames"]
