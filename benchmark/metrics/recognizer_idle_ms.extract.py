"""Idle ms of the card an extraction request while the host is in the
program's ``style.recognizer`` span (the recognizer and its frame mask),
innermost."""

from harness import program_spans


def read(m):
    return program_spans.idle_ms(m, ("style.recognizer",), "style.extract")
