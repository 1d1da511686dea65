"""Assigned architecture config: tinyllama-1.1b (see registry for source).

Exposes CONFIG (exact published hyper-parameters) and SMOKE (reduced copy
for CPU smoke tests).  Select with ``--arch tinyllama-1.1b``.
"""
from .registry import get_config

CONFIG = get_config("tinyllama-1.1b")
SMOKE = CONFIG.reduced()
