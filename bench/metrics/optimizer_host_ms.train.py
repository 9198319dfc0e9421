"""Host milliseconds a training step in the program's ``train.optimizer``
span (`optim/adamw.py adamw_update`), over the traced window's steps;
``time.perf_counter_ns`` at the span's ends. The span records only under
the profiler, which adds its own cost to each of AdamW's launches, and
its host time includes any wait for room in the launch queue (the
backward's tail is still queued when it opens): the host's time in the
optimizer under the profiler, not the dispatch cost of an untraced step."""
from benchkit.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "train", "train.optimizer", "host")
