"""portal_cycles: the portal scheduler's cycles a render (one cheap launch
and one resolve launch each, ``RenderStats.extra["cycles"]``), the mean over
the window's renders. Renders of another route report none."""


def read(ctx, out):
    cycles = out.counters.get("cycles")
    return sum(cycles) / len(cycles) if cycles else None
