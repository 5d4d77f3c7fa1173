"""Idle ms of the card a generation request while the host is in the
program's ``gen.spacer`` span (the spacer's counts) or ``gen.insert_spaces``
span (the spaced class map), innermost."""

from harness import program_spans


def read(m):
    return program_spans.idle_ms(m, ("gen.spacer", "gen.insert_spaces"),
                                 "gen.request")
