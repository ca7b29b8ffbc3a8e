"""ops subpackage: frontend and the hand-written Hopper kernels."""
