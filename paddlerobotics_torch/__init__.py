"""PyTorch/CUDA port of paddlerobotics_tpu.

A package of its own beside the JAX reference: it imports torch, numpy and
scipy, and nothing of JAX or of ``paddlerobotics_tpu``. Layout and function
names mirror the JAX package; the physics control step runs as a
hand-written CUDA kernel (``ops/csrc/physics_step.cu``) on the card and as
its plain PyTorch version on the CPU.
"""
