"""Share of build rows a grafted query found already built (represented),
of all build rows its members needed, over the window."""


def read(run):
    rep = run.delta("represented_rows")
    total = rep + run.delta("residual_build_rows") + run.delta("ordinary_build_rows")
    return 100.0 * rep / total if total > 0 else None
