"""PyTorch/CUDA port of the serving paths: the KDLAE-T teacher, the KDLAE-S
student and the ASDQE scorer.

Mirrors the module layout of ``rethink_acoustic_image_enhancement_tpu``
(the JAX reference) so each module's counterpart is found at the same
relative path. Modules are NCHW ``nn.Module``s with the reference torch
attribute names; the four TPU kernels are hand-written CUDA kernels for
Hopper (``csrc/``), each with a plain PyTorch version beside it.

Imports torch, numpy and the standard library only.
"""
