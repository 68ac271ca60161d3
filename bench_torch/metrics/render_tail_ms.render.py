"""render_tail_ms.render: the host's tail of a render, in ms: the mean over
the traced renders of the end of the program's ``render`` span less the end
of its ``render.wait`` span (the sync a traced render makes before its
fetch), so the fetch, finalize, the unpermute and the image's hash, while a
closed loop leaves the device idle. Read from the program's span log
(``path_tracer_tpu_torch.utils.profiling.spans``); a program without one
reports nothing."""


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    ends: dict = {}
    for s in profiling.spans():
        if s.name in ("render", "render.wait") and s.end_ns:
            ends.setdefault(s.unit, {})[s.name] = s.end_ns
    tails = [e["render"] - e["render.wait"] for e in ends.values()
             if "render" in e and "render.wait" in e]
    return 1e-6 * sum(tails) / len(tails) if tails else None
