"""train subpackage: train state and SGD step, checkpoints, epoch engine."""
