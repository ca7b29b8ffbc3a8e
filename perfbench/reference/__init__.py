"""The plain reference: straightforward PyTorch and numpy in float32 (TF32
off), written from the published descriptions and the configs, importing
nothing of the program. It reads the benchmark's own files and seeds and
works out again whatever the program derives from them (crops, targets,
decoded frames, spectrograms, weights' updates). ``precision="fp8"``
rounds every convolution's and matrix product's inputs and weights to
float8 (e4m3, one scale a tensor): the control, which has to come out as
not correct.
"""
