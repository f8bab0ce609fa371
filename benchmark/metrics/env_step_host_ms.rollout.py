"""Host ms per ``BatchedQuadrupedEnv.step`` call, averaged over every
call in the timed window (host clock around the call)."""

from benchmark.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "env.step")
