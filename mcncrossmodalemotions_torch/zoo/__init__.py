"""zoo subpackage: ``build_student``, ``load_pretrained_student``,
``student_loss_fn``, ``build_teacher``, ``load_pretrained_teacher``, the
weight bridge and the MatConvNet importer (``zoo.matconvnet``)."""

from mcncrossmodalemotions_torch.zoo.bridge import (
    random_student_variables,
    random_teacher_variables,
    student_params_from_flax,
    student_state_dict_from_flax,
    teacher_state_dict_from_flax,
)
from mcncrossmodalemotions_torch.zoo.registry import (
    STUDENT_MODELS,
    TEACHER_MODELS,
    build_student,
    build_teacher,
    load_pretrained_student,
    load_pretrained_teacher,
    student_loss_fn,
)

__all__ = ["STUDENT_MODELS", "TEACHER_MODELS", "build_student",
           "build_teacher", "load_pretrained_student",
           "load_pretrained_teacher", "random_student_variables",
           "random_teacher_variables", "student_loss_fn",
           "student_params_from_flax", "student_state_dict_from_flax",
           "teacher_state_dict_from_flax"]
