"""Mean cases in a fused service window over the windows the service
closed during the measured window (``ExtractionService.stats()``)."""


def read(run):
    n = run.counters.get("window_cases")
    return sum(n) / len(n) if n else None
