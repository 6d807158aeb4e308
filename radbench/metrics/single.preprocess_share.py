"""Share of the single-case API's staged time spent in host preprocessing
(``StageTimes.preprocess_ms`` over ``total_ms``, summed over the window), in %."""


def read(run):
    total = run.counters.get("total_ms")
    if not total:
        return None
    return 100.0 * run.counters["preprocess_ms"] / total
