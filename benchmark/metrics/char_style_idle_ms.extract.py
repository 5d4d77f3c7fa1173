"""Idle ms of the card an extraction request while the host is in the
program's ``style.char_style`` spans (the author collapse, the char style
encoder, the repeat and the packing), innermost."""

from harness import program_spans


def read(m):
    return program_spans.idle_ms(m, ("style.char_style",), "style.extract")
