"""Data parallel over ranks with ``torch.distributed`` (``parallel.mesh``)."""
