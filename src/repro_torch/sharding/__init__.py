"""Sharding: the population axis of stacked scoring split across devices
(``population.py``)."""
