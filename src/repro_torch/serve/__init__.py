"""Serving: the slot-based batching engine (``engine.py``) and the
placement-design service (``design.py``)."""
