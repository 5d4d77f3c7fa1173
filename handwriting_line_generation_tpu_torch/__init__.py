"""PyTorch/CUDA port of ``handwriting_line_generation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name so a reader finds one from the other.  This package
imports ``torch``, ``numpy`` and the standard library only — never ``jax``,
``flax`` or the JAX package.

Ported so far: the generation slice (text + style -> handwriting line),
HWR pretraining, and style extraction with autoencode.

  - ``charset`` / ``config``        — copies of the codecs, greedy CTC
                                      decoding, the configs and their loader
  - ``convert`` / ``init``          — flax param trees -> state_dicts; seeded
                                      flax-distributed init in numpy
  - ``models``                      — spacer ``CountCNN``, ``SpacedGenerator``,
                                      ``HWWithStyle`` (generation, style
                                      extraction, autoencode), the
                                      recognizer ``CNNOnlyHWR``, the style
                                      encoder ``CharStyleEncoder``
  - ``ops``                         — ``insert_spaces``; augmentation;
                                      Viterbi and DTW alignment; the
                                      generator block epilogue and the CTC
                                      forward-backward, hand-written CUDA
                                      kernels (``csrc/gen_epilogue.cu``,
                                      ``csrc/ctc.cu``)
  - ``inference``                   — ``GenerationSession``; the style bank
                                      (``StyleExtractor``, ``.npz`` I/O,
                                      style-space statistics)
  - ``data``                        — line records, bucketed batchers,
                                      ``Prefetcher``, cv2-free fg masks
  - ``training`` / ``utils``        — ``HWRTrainer``, LR schedules + Adam;
                                      error rates, ``TrainLog``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
