"""zoo subpackage: ``build_student`` and the weight bridge."""

from mcncrossmodalemotions_torch.zoo.bridge import (
    random_student_variables,
    student_state_dict_from_flax,
)
from mcncrossmodalemotions_torch.zoo.registry import (
    STUDENT_MODELS,
    build_student,
)

__all__ = ["STUDENT_MODELS", "build_student", "random_student_variables",
           "student_state_dict_from_flax"]
