"""PyTorch/CUDA port of ``handwriting_line_generation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name so a reader finds one from the other.  This package
imports ``torch``, ``numpy`` and the standard library only — never ``jax``,
``flax`` or the JAX package.

Ported so far (the generation slice): text + style -> handwriting line.

  - ``charset`` / ``config``        — copies of the codec and model configs
  - ``convert`` / ``init``          — flax param tree -> state_dict; seeded
                                      flax-distributed init in numpy
  - ``models``                      — spacer ``CountCNN``, ``SpacedGenerator``,
                                      ``HWWithStyle`` (generation flows)
  - ``ops``                         — ``insert_spaces``; the generator block
                                      epilogue, a hand-written CUDA kernel
                                      (``csrc/gen_epilogue.cu``)
  - ``inference``                   — ``GenerationSession``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
