"""models subpackage: the VGG-M student and its pipeline, the face
teachers (ResNet50/SENet50, the classic VGGFace) and their pipeline, and
the surgery on their weights."""

from mcncrossmodalemotions_torch.models.pipeline import AudioStudentPipeline
from mcncrossmodalemotions_torch.models.resnet import (
    ResNet,
    ResNet50,
    SENet50,
)
from mcncrossmodalemotions_torch.models.teacher_pipeline import (
    FaceTeacherPipeline,
)
from mcncrossmodalemotions_torch.models.vggface import VGGFace
from mcncrossmodalemotions_torch.models.vggm import (
    VGGMStudent,
    temporal_valid_frames,
)

__all__ = ["AudioStudentPipeline", "FaceTeacherPipeline", "ResNet",
           "ResNet50", "SENet50", "VGGFace", "VGGMStudent",
           "temporal_valid_frames"]
