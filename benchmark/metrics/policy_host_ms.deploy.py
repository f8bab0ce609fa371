"""Host ms per ``DeployPolicy`` call, averaged over every tick in the
timed window (host clock around the call)."""

from benchmark.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "policy")
