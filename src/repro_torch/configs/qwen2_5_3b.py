"""Assigned architecture config: qwen2.5-3b (see registry for source).

Exposes CONFIG (exact published hyper-parameters) and SMOKE (reduced copy
for CPU smoke tests).  Select with ``--arch qwen2.5-3b``.
"""
from .registry import get_config

CONFIG = get_config("qwen2.5-3b")
SMOKE = CONFIG.reduced()
