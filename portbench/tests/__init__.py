"""The benchmark's CPU tests (and, marked ``cuda``, its card tests)."""
