"""setup_kernels_s: the seconds the run's process spent loading its kernel
libraries: the sum over the program's load records
(``path_tracer_tpu_torch.utils.profiling.loads``, one a library loaded,
kept with or without a profiler) of the seconds hashing the sources,
building the library (0 when ``_build/`` already holds it) and
``ctypes.CDLL``. Nearly all of it falls in set-up, when the warm unit
first launches each kernel. A program without the records, or a run that
loaded no library, reports nothing."""


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    if not hasattr(profiling, "loads"):
        return None
    records = profiling.loads()
    return sum(r.seconds for r in records) if records else None
