"""Assigned architecture config: grok-1-314b (see registry for source).

Exposes CONFIG (exact published hyper-parameters) and SMOKE (reduced copy
for CPU smoke tests).  Select with ``--arch grok-1-314b``.
"""
from .registry import get_config

CONFIG = get_config("grok-1-314b")
SMOKE = CONFIG.reduced()
