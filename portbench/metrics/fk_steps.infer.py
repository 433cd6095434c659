"""Sequential bone compositions of the forward kinematics per batch over
the window: the program's counter ``bodymodel/core.py::FK["steps"]``, which
the loop reads around each call (``State.fk_steps`` over
``State.fk_batches``). None where the program has no such counter."""


def read(ctx):
    s = ctx["state"]
    steps, batches = getattr(s, "fk_steps", 0), getattr(s, "fk_batches", 0)
    return steps / batches if steps and batches else None
