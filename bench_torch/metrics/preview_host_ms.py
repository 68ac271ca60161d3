"""preview_host_ms: the host's time a preview frame, in ms: the mean over
the traced frames of the program's ``preview.issue`` span (the frame's
launches up to its last enqueue) plus the ``preview.move`` that opened the
frame (0 on still frames). The fetch, which waits for the device, is left
out. Read from the program's span log
(``path_tracer_tpu_torch.utils.profiling.spans``) in a ``--trace 1`` run,
so it holds the profiler's own cost for each operation it records: compare
it only with other traced readings. A program without the log reports
nothing."""


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    host: dict = {}
    for s in profiling.spans():
        if s.end_ns and s.name in ("preview.issue", "preview.move"):
            frame = host.setdefault(s.unit, [False, 0])
            frame[0] |= s.name == "preview.issue"
            frame[1] += s.end_ns - s.start_ns
    frames = [ns for issued, ns in host.values() if issued]
    return 1e-6 * sum(frames) / len(frames) if frames else None
