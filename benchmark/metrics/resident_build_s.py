"""Resident dataset layer: seconds of Trainer._fresh_cache for both roles
and a synchronize (parse and upload)."""

from benchmark.readers import resident_build_s as read  # noqa: F401
