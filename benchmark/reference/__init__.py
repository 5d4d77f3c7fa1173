"""The benchmark's plain reference of the handwriting models.

A frozen copy of the program's plain PyTorch paths (the configuration, the
charset, the models, spacing, alignment, augmentation, the losses, the
curriculum and the text sampler), cut loose from the program: it imports
nothing of it, and nothing of JAX.  The two hand-written kernels are not
here: the generator runs its plain epilogue (``fused_epilogue`` off) and
CTC is PyTorch's own (:mod:`reference.ops.ctc`).  :mod:`reference.gan`
follows the GAN trainer's lessons, :mod:`reference.run` holds the three
cells' reference computations and the lower-precision controls.

Later changes to the program do not touch these files: they are the
yardstick the program is judged by.
"""
