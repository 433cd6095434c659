"""Share of a traced sub-window in which no kernel ran on the card."""


def idle_pct(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
