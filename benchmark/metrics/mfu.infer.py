"""The whole step's share of the card's datasheet peak, in percent: the
float operations of the window's steps (each kind of step counted once,
in the warm-up, by ``counts.flops``) over the window's seconds and the
peak of the configuration's precision (989 TFLOP/s bfloat16, 495 TF32)."""


def read(m):
    flops = sum(m.cell.flops.get(kind, 0.0) for kind, _, _, _
                in m.window.steps)
    if flops <= 0 or m.cell.peak_flops <= 0:
        return None
    return 100.0 * flops / m.window.seconds / m.cell.peak_flops
