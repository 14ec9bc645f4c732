"""The benchmark's harness: the manifest, the window, the trace and the
checks (see portbench/README.md)."""
