"""zoo subpackage: ``build_student``, ``load_pretrained_student``,
``resolve_release`` (registry names, ``zoo.artifacts``),
``student_loss_fn``, ``build_teacher``, ``load_pretrained_teacher``, the
teacher fine-tuning entry points and ``teacher_loss_fn``, the weight bridge
and the MatConvNet importer (``zoo.matconvnet``)."""

from mcncrossmodalemotions_torch.zoo.bridge import (
    random_student_variables,
    random_teacher_variables,
    random_vggface_variables,
    student_params_from_flax,
    student_state_dict_from_flax,
    teacher_params_from_flax,
    teacher_state_dict_from_flax,
)
from mcncrossmodalemotions_torch.zoo.registry import (
    CLASSIC_MODELS,
    STUDENT_MODELS,
    TEACHER_MODELS,
    VGGFACE2_MODELS,
    build_student,
    build_teacher,
    load_pretrained_student,
    load_pretrained_teacher,
    prepare_classic_from_base,
    prepare_teacher_from_base,
    resolve_release,
    student_loss_fn,
    teacher_loss_fn,
)

__all__ = ["CLASSIC_MODELS", "STUDENT_MODELS", "TEACHER_MODELS",
           "VGGFACE2_MODELS", "build_student", "build_teacher",
           "load_pretrained_student", "load_pretrained_teacher",
           "prepare_classic_from_base", "prepare_teacher_from_base",
           "random_student_variables", "random_teacher_variables",
           "random_vggface_variables", "resolve_release", "student_loss_fn",
           "student_params_from_flax", "student_state_dict_from_flax",
           "teacher_loss_fn", "teacher_params_from_flax",
           "teacher_state_dict_from_flax"]
