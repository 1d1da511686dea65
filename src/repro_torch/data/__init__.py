"""The synthetic token pipeline."""
