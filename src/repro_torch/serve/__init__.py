"""Serving: the slot-based batching engine (``engine.py``)."""
