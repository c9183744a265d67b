"""GiB of the trainer's history caches on the device: every ``M_in`` and
``M_ag`` table it holds (layer: history caches)."""


def read(ctx):
    return ctx.cache_bytes / float(1 << 30) if ctx.cache_bytes else None
