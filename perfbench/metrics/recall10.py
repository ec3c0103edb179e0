"""recall10 (fraction, higher): mean recall@10 of every answer of the
window (the first 10 ids returned) against the reference's exact 10
nearest (``reference/check.py``)."""


def read(run):
    return run["recall10"] if run["calls"] else None
