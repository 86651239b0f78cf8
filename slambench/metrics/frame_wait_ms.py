"""io (``cli.open_frames`` → ``io.native_loader.NativeFrameLoader``): host ms a
frame that ``run_frames`` waits in its frame source's ``next()``, over the
frames the window pulled."""

NEEDS = ()


def read(run):
    waits = [w for s in run.sequences for w in s.waits]
    return 1e3 * sum(waits) / len(waits) if waits else None
