"""Idle ms of the card a reconstruction request while the host is in the
program's ``recon.generator`` span (the style MLP, the styled blocks and
the epilogue kernel's launches, the head), innermost."""

from harness import program_spans


def read(m):
    return program_spans.idle_ms(m, ("recon.generator",), "recon.request")
