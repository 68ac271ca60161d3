"""portal_host_ms: the portal scheduler's own host time a render, in ms:
the mean over the traced renders of the summed ``portal.issue`` (a batch of
cycles' launches), ``portal.compact`` (tail compaction, redistribution) and
``portal.merge`` (the stages' merge) spans, less the ``.wait`` spans inside
them, where the host blocks on the device. Read from the program's span log
(``path_tracer_tpu_torch.utils.profiling.spans``) in a ``--trace 1`` run:
it is a profiled host time, which holds the profiler's own cost for each
torch operation it records (on an H100 host it read 40-60% above the same
spans logged with no profiler), so it moves with the number of torch
operations the scheduler issues as well as with its Python time. Compare it
only with other traced readings. A program without the log, or renders of
another route, report nothing."""

HOST = ("portal.issue", "portal.compact", "portal.merge")


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    log = profiling.spans()
    per_unit: dict = {}
    for s in log:
        if not s.end_ns:
            continue
        if s.name in HOST:
            per_unit[s.unit] = per_unit.get(s.unit, 0) + s.end_ns - s.start_ns
        elif s.name.endswith(".wait"):
            # a wait counts against the innermost scheduler span around it
            p = s.parent
            while p >= 0 and log[p].name not in HOST:
                p = log[p].parent
            if p >= 0:
                per_unit[s.unit] = per_unit.get(s.unit, 0) - (s.end_ns - s.start_ns)
    return 1e-6 * sum(per_unit.values()) / len(per_unit) if per_unit else None
