"""Conformance oracles: the dav1d decode harness."""
