"""Serving substrate: dynamic folding of concurrent requests over shared
KV-prefix state (the paper's mechanism transferred to LM serving —
DESIGN.md §6)."""
