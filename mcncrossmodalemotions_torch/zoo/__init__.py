"""zoo subpackage: ``build_student``, ``load_pretrained_student``,
``student_loss_fn``, the weight bridge and the MatConvNet importer
(``zoo.matconvnet``)."""

from mcncrossmodalemotions_torch.zoo.bridge import (
    random_student_variables,
    student_params_from_flax,
    student_state_dict_from_flax,
)
from mcncrossmodalemotions_torch.zoo.registry import (
    STUDENT_MODELS,
    build_student,
    load_pretrained_student,
    student_loss_fn,
)

__all__ = ["STUDENT_MODELS", "build_student", "load_pretrained_student",
           "random_student_variables",
           "student_loss_fn", "student_params_from_flax",
           "student_state_dict_from_flax"]
