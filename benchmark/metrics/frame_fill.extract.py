"""Share of the recognizer's frames that lie inside the lines, in
percent: the program's counters ``style.frames_used`` (each line's frames,
at most the recognizer's T) over ``style.frames_slots`` (batch x T)."""

from harness import program_spans


def read(m):
    return program_spans.fill(m, "style.frames_used", "style.frames_slots")
