"""The multi-device path: slab layout, host plan, halo exchange and the
sharded trainer over ``torch.distributed`` (``spatial.py``), and the
launcher that runs one process per rank (``launch.py``)."""
