"""Cases completed in the window over the window's seconds (host clock);
a closed loop's rate over all the work and all the time of the window."""


def read(run):
    if run.loop != "closed" or run.window_s <= 0:
        return None
    return run.cases / run.window_s
