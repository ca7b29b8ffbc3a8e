"""models subpackage: the VGG-M student and its pipeline, the ResNet/SENet
face teachers and theirs."""

from mcncrossmodalemotions_torch.models.pipeline import AudioStudentPipeline
from mcncrossmodalemotions_torch.models.resnet import (
    ResNet,
    ResNet50,
    SENet50,
)
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.models.vggm import (
    VGGMStudent,
    temporal_valid_frames,
)

__all__ = ["AudioStudentPipeline", "FaceTeacherPipeline", "ResNet",
           "ResNet50", "SENet50", "VGGMStudent", "temporal_valid_frames"]
