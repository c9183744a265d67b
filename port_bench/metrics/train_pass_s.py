"""Seconds of one ``Trainer.train_epoch()`` in the traced window: the
benchmark's span around the call, ended by ``torch.cuda.synchronize()``,
the mean over the window's epochs (layer: trainer)."""


def read(ctx):
    spans = ctx.spans["train_epoch"]
    return sum(spans) / len(spans) if spans else None
