"""Idle ms of the card a reconstruction request while the host is in the
program's ``recon.align`` span (``viterbi_align``: the max-plus recursion
over the frames and its backtrace), innermost."""

from harness import program_spans


def read(m):
    return program_spans.idle_ms(m, ("recon.align",), "recon.request")
