"""Mean milliseconds of the card's work a reconstruction request, by CUDA
events recorded around each request of the window."""


def read(m):
    ms = m.cell.event_ms("request")
    return sum(ms) / len(ms) if ms else None
