"""Share of fused-chain attempts (B1 launches plus declines) that the
backend declined to the staged probes or the host, over the window."""

from graftbench.readings import DECLINE_REASONS


def read(run):
    declined = sum(run.delta(f"fallback_probes_{r}") for r in DECLINE_REASONS)
    total = declined + run.delta("kernel_chain_launches")
    return 100.0 * declined / total if total > 0 else None
