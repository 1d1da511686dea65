"""Assigned architecture config: smollm-360m (see registry for source).

Exposes CONFIG (exact published hyper-parameters) and SMOKE (reduced copy
for CPU smoke tests).  Select with ``--arch smollm-360m``.
"""
from .registry import get_config

CONFIG = get_config("smollm-360m")
SMOKE = CONFIG.reduced()
