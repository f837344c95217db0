"""Conformance oracles: the dav1d decode harness and the libaom probe."""
