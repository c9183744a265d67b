"""Seconds of one ``Trainer.evaluate()`` (the layer-wise refresh of every
cache and the logits, then the split accuracies) in the traced window:
the benchmark's synchronised span, the mean over the window's epochs
(layer: refresh)."""


def read(ctx):
    spans = ctx.spans["evaluate"]
    return sum(spans) / len(spans) if spans else None
