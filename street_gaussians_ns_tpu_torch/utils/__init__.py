"""Host-side utilities: metrics writer, the dataclass CLI bridge, the
optional image libraries, the live viewer, the spans and host-sync
counts (profiling)."""
