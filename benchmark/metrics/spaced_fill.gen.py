"""Share of the rendered spaced positions the lines fill, in percent:
the program's counters ``gen.spaced_used`` (each line's spaced length, at
most ``spaced_len``) over ``gen.spaced_slots`` (batch x ``spaced_len``)."""

from harness import program_spans


def read(m):
    return program_spans.fill(m, "gen.spaced_used", "gen.spaced_slots")
