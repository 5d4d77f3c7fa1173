"""PyTorch/CUDA port of ``handwriting_line_generation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name so a reader finds one from the other.  This package
imports ``torch``, ``numpy`` and the standard library only — never ``jax``,
``flax`` or the JAX package.

Ported so far: the generation slice (text + style -> handwriting line) and
HWR pretraining.

  - ``charset`` / ``config``        — copies of the codecs, greedy CTC
                                      decoding, the configs and their loader
  - ``convert`` / ``init``          — flax param trees -> state_dicts; seeded
                                      flax-distributed init in numpy
  - ``models``                      — spacer ``CountCNN``, ``SpacedGenerator``,
                                      ``HWWithStyle`` (generation flows),
                                      the recognizer ``CNNOnlyHWR``
  - ``ops``                         — ``insert_spaces``; augmentation; the
                                      generator block epilogue and the CTC
                                      forward-backward, hand-written CUDA
                                      kernels (``csrc/gen_epilogue.cu``,
                                      ``csrc/ctc.cu``)
  - ``inference``                   — ``GenerationSession``
  - ``training`` / ``utils``        — ``HWRTrainer``, LR schedules + Adam;
                                      error rates, ``TrainLog``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
