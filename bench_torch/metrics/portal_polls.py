"""portal_polls: the portal scheduler's host syncs a render (its drive's
polls, ``RenderStats.extra["polls"]``), the mean over the window's renders.
Renders of another route report none."""


def read(ctx, out):
    polls = out.counters.get("polls")
    return sum(polls) / len(polls) if polls else None
