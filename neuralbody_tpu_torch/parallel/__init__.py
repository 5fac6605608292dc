"""Feeding the card: the device geometry bank (geom.py) and the pinned,
side-stream prefetch of dispatch groups (transfer.py)."""
