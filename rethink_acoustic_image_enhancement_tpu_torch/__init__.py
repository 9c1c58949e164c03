"""PyTorch/CUDA port of the KDLAE-T teacher serving path.

Mirrors the module layout of ``rethink_acoustic_image_enhancement_tpu``
(the JAX reference) so each module's counterpart is found at the same
relative path. Modules are NCHW ``nn.Module``s with the reference torch
attribute names; the stage megakernel is a hand-written CUDA kernel for
Hopper (``csrc/stage.cu``) with a plain PyTorch version beside it.

Imports torch, numpy and the standard library only.
"""
