"""prep_copy_mb.render: the bytes a render copies from the host to the
device in ``pipeline.prepare_render``, in MB: the mean over the traced
renders of the summed sizes of the program's ``render.prepare.copy`` spans
in each (the ``nbytes`` of the route's tables), / 1e6. Read from the
program's span log (``path_tracer_tpu_torch.utils.profiling.spans``),
grouped by the span's unit; a program without the span reports nothing."""

SPAN = "render.prepare.copy"


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    per_unit: dict = {}
    for s in profiling.spans():
        if s.name == SPAN and s.unit and s.size is not None:
            per_unit[s.unit] = per_unit.get(s.unit, 0) + s.size
    return 1e-6 * sum(per_unit.values()) / len(per_unit) if per_unit else None
