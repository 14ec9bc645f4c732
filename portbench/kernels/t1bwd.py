"""T1-bwd, the backward of delta tracking's fixed-length replay
(csrc/medium_track.cu): launches counted, for the trace's completeness
check. No logical count yet (no `work`, so no roofline share): a tracked
lane's steps, which set the grid cells it reads, come only from replaying
its tracking (PERF.md, Open questions)."""

TRACE_NAME = "medium_delta_track_bwd_kernel"
WRAPPER = ("mitsuba_customization_tpu_torch.render.medium", "_launch_bwd")


def record(args, kwargs, out):
    """The call's lanes, for calls of this kernel's kind (None for the
    other kind, which the same wrapper launches)."""
    if args[0] != "delta":
        return None
    return {"lanes": int(args[3].shape[0])}
