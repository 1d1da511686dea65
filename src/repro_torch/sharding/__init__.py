"""Sharding: the population axis of stacked scoring split across devices
(``population.py``); the LM's partition specs (``rules.py``) and the mesh
context that lays tensors out by them as DTensors (``partition.py``)."""
