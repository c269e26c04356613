"""The benchmark's general machinery: it names no cell, configuration,
traffic mix or metric (harness/spec.py finds them by name)."""
