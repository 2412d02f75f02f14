"""Seconds of the trainer's construction spent in `build_stores` (the
seed cloud's k-d tree and the initial stores), the trainer's own count."""


def read(ctx):
    return ctx["setup_seconds"].get("build_stores")
