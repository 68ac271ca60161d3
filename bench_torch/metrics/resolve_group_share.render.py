"""resolve_group_share.render: the share of K3's resolve segments that it
traced with a group of lanes: over the traced renders, the sizes of the
``render.resolve.group`` records in the program's span log
(``path_tracer_tpu_torch.utils.profiling.spans``; per render
``RenderStats.extra["resolve_group_items"]``, the live items whose line
enters a tile in a scene of more tiles than K3's sort key holds) over the
sizes of their ``render.resolve`` records (the segments K3 resolved). A
record's tag, the lanes an item, is printed beside the reading. A program
without the records, or renders of another route, report nothing."""


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    if out.trace is None or not hasattr(profiling, "spans"):
        return None
    log = profiling.spans()
    groups = [s for s in log if s.name == "render.resolve.group"]
    segments = sum(s.size for s in log if s.name == "render.resolve" and s.size)
    if not groups or segments <= 0:
        return None
    items = sum(s.size for s in groups)
    lanes = sorted({str(s.tag) for s in groups})
    print(f"resolve_group_share.render: {items} items traced by "
          f"{'/'.join(lanes)} lanes of {segments} resolve segments over "
          f"{len(groups)} renders", flush=True)
    return items / segments
