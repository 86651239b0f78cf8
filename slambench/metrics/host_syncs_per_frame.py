"""runner (``runner.run_frames``): the host's syncs with the card over the
window (``torch.cuda.set_sync_debug_mode("warn")``), a frame pulled."""

NEEDS = ("syncs",)


def read(run):
    if run.syncs is None or not run.sync_frames:
        return None
    return run.syncs / run.sync_frames
