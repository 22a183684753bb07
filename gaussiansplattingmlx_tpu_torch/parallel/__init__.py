"""Data- and tile-parallel training on ``torch.distributed`` (``sharding``),
multi-host view stores (``multihost``) and the local rank launcher
(``launch``)."""
