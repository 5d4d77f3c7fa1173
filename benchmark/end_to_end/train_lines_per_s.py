"""``train_lines_per_s``: every line of the lessons completed in the
window (text lessons included), over the window's seconds; each lesson
ends in a synchronize."""


def read(m):
    return m.window.lines / m.window.seconds
