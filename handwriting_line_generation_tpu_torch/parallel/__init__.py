"""Multi-process training: the rank grid and its collectives
(``parallel.mesh``)."""
