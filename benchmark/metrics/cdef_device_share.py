"""cdef_device_share (%, SVT_TRACE frame counter `cdef.device`): 100 x
the mean of the counter over the window's frames that hold it. A frame
counts 1.0 where FastIntraEncoder ran its CDEF search and apply through
the CUDA kernel (svt_av1_psy_tpu_torch/kernels/cdef.py), 0.0 where it
ran the host C (native.cdef_run). None, and nothing raised, where no
frame holds it: an untraced run, or a program without the counter."""


def read(ctx):
    vals = [r["cdef.device"] for r in getattr(ctx, "records", None) or ()
            if "cdef.device" in r]
    if not vals:
        return None
    return 100.0 * sum(vals) / len(vals)
