"""Assigned architecture config: llava-next-34b (see registry for source).

Exposes CONFIG (exact published hyper-parameters) and SMOKE (reduced copy
for CPU smoke tests).  Select with ``--arch llava-next-34b``.
"""
from .registry import get_config

CONFIG = get_config("llava-next-34b")
SMOKE = CONFIG.reduced()
