"""Document-sharded serving over several devices (``sharding.py``)."""
