"""Mean milliseconds of an auto lesson (``GanTrainer.run_lesson`` of
``["auto", "auto-gen"]``: autoencode, Viterbi, the per-group VJPs, the
balanced merge, Adam), host clock around each one of the window, ending in
a synchronize."""


def read(m):
    s = m.window.latencies_s("auto")
    return 1e3 * sum(s) / len(s) if s else None
