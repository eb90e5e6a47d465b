"""Utilities: the msgpack reader, metric logging, the device-init watchdog and
profiling helpers."""
