"""``infer_lines_per_s``: every line of the requests completed in the
window, over the window's seconds (from its start to the end of its last
request)."""


def read(m):
    return m.window.lines / m.window.seconds
