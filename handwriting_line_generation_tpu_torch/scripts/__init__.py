"""The port's counterparts of the repository's ``scripts/*.py`` and root
scripts (which stay JAX): the synthetic text corpus, the ``spaced_loc``
alignment cache and a split's transcription list."""
