"""Host syncs the executor counted (``transfer_log``) over the measured
window, per stream window."""


def read(run):
    windows = run.counters.get("windows")
    if not windows:
        return None
    return run.counters["fetches"] / windows
