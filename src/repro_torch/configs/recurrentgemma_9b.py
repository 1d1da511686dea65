"""Assigned architecture config: recurrentgemma-9b (see registry for source).

Exposes CONFIG (exact published hyper-parameters) and SMOKE (reduced copy
for CPU smoke tests).  Select with ``--arch recurrentgemma-9b``.
"""
from .registry import get_config

CONFIG = get_config("recurrentgemma-9b")
SMOKE = CONFIG.reduced()
