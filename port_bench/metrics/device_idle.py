"""Share of the traced window in which no operation ran on the device, in
percent: one minus the union of the kernel, copy and fill intervals of
the ``torch.profiler`` trace (never their sum) over the window (layer:
device)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0.0 or t.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
