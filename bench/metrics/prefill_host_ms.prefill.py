"""Host milliseconds a call in the program's ``prefill`` span (all of
`models/lm.py prefill`: launching the embedding, every layer, the final
norm and the head), over the traced window's calls;
``time.perf_counter_ns`` at the span's ends. The span records only under
the profiler, which adds its own cost to each launch, and its host time
includes any wait for room in the launch queue (most of a long prompt's
call): the host's time in prefill under the profiler, not the dispatch
cost of an untraced call."""
from benchkit.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "prefill", "prefill", "host")
