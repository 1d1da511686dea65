"""Training: AdamW (``optimizer``), the train step (``step``) and the
fault-tolerant loop (``loop``)."""
