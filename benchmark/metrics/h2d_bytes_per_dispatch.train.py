"""Bytes the feed copies to the card a dispatch: the staging ring's
set_bytes (parallel/transfer.StagingRing)."""


def read(run):
    return run.traced_info.get("staging_bytes") or None
