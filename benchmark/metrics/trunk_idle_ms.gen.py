"""Idle ms of the card a generation request while the host is in the
program's ``gen.generator`` span (``generate_spaced``: the style MLP, the
styled blocks and the epilogue kernel's launches), innermost."""

from harness import program_spans


def read(m):
    return program_spans.idle_ms(m, ("gen.generator",), "gen.request")
