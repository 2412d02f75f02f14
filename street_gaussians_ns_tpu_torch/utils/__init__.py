"""Host-side utilities: metrics writer, the dataclass CLI bridge, the
optional image libraries, the live viewer, profiling helpers."""
