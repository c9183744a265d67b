"""Share of the window's epochs that trained fused, as replays of one
captured step (the ``fused`` field of each ``train_epoch()`` record), in
percent (layer: fused epoch)."""


def read(ctx):
    if not ctx.epochs:
        return None
    return 100.0 * sum(bool(e.get("fused")) for e in ctx.epochs) / len(ctx.epochs)
