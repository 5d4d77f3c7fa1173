"""``setup_s``: seconds from the start of the run to the window's start:
imports, the kernels' load (a build only in a checkout's first run),
weights, inputs and the warm-up of every shape the window uses."""


def read(m):
    return m.setup_s
