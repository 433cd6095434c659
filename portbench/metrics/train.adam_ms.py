"""Device milliseconds per step under ``Optimizer.step#Adam.step`` (the
kernels of Adam's update and of its children), over the steps inside the
traced sub-window."""


def read(ctx):
    tr, n = ctx["trace"], getattr(ctx["state"], "traced_units", 0)
    if tr is None or not n:
        return None
    s = tr.op_device_s("Optimizer.step#Adam.step")
    return 1e3 * s / n if s > 0 else None
