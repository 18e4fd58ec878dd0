"""device_idle_pct.pose: the share of the traced window of pose steps in
which no kernel runs on the card (the union of the profiler's kernel
intervals), in %. Moves train_step_ms."""


def read(ctx):
    if ctx["loop"] != "pose" or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
