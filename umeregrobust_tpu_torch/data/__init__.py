"""Synthetic scenes, SEM resampling and the benchmark-suite pair builder
(numpy + scipy)."""
