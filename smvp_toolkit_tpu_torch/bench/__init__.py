"""Benchmark harness: device-synchronised timing, roofline and report files."""
