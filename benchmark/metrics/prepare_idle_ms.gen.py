"""Idle ms of the card a generation request while the host is in the
program's ``gen.prepare`` span (``encode_texts`` of the texts and the styles'
upload) and in no span inside it."""

from harness import program_spans


def read(m):
    return program_spans.idle_ms(m, ("gen.prepare",), "gen.request")
