"""Assigned architecture config: seamless-m4t-medium (see registry for source).

Exposes CONFIG (exact published hyper-parameters) and SMOKE (reduced copy
for CPU smoke tests).  Select with ``--arch seamless-m4t-medium``.
"""
from .registry import get_config

CONFIG = get_config("seamless-m4t-medium")
SMOKE = CONFIG.reduced()
