"""Assigned architecture config: falcon-mamba-7b (see registry for source).

Exposes CONFIG (exact published hyper-parameters) and SMOKE (reduced copy
for CPU smoke tests).  Select with ``--arch falcon-mamba-7b``.
"""
from .registry import get_config

CONFIG = get_config("falcon-mamba-7b")
SMOKE = CONFIG.reduced()
