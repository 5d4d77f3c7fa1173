"""The CTC kernel's share of its roofline, in percent: the least time of
the window's CTC launches (``counts.bounds``, from each launch's shape)
over the device time of the kernel's launches (``ctc_kernel`` in the
profile)."""

KERNEL = "ctc_kernel"


def read(m):
    if m.trace is None:
        return None
    dev_s, n = m.trace.kernel_seconds(KERNEL)
    per_kind = m.cell.bounds.get(KERNEL, {})
    bound_s = sum(per_kind.get(kind, 0.0) for kind, _, _, _
                  in m.window.steps)
    if n == 0 or dev_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / dev_s
