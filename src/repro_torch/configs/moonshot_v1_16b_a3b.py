"""Assigned architecture config: moonshot-v1-16b-a3b (see registry for source).

Exposes CONFIG (exact published hyper-parameters) and SMOKE (reduced copy
for CPU smoke tests).  Select with ``--arch moonshot-v1-16b-a3b``.
"""
from .registry import get_config

CONFIG = get_config("moonshot-v1-16b-a3b")
SMOKE = CONFIG.reduced()
