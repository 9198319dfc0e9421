"""The port's timed spans (`repro_torch.obs.spans`) on the CPU.

With no profiler running the train step and `lm.prefill` open no
``record_function`` range, make no CUDA event and leave no span. Under a
CPU ``torch.profiler`` session a train step records ``train.forward``,
``train.backward`` and ``train.optimizer`` once each, and a prefill one
``prefill`` span with a ``prefill.mixer`` and a ``prefill.ffn`` child a
layer, tagged with the layer's kinds; the same names are user
annotations on the profiler's timeline inside the range that encloses
the call. Results are bit-identical with spans on and off. `summary`
keeps the spans that began inside its window, and sums the card's time
from the event pairs (a stand-in event on the CPU); the parent stack is
each thread's own, and a new profiler session drops the spans of the
sessions before it."""
import threading
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import load_config, smoke_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.obs import spans
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import flatten

torch.set_num_threads(1)

TRAIN_NAMES = ["train.forward", "train.backward", "train.optimizer"]
#: dense attention, the hybrid (mamba and attention mixers, MoE and dense
#: ffns) and RWKV-6 (its channel mix as the ffn)
PREFILL_CONFIGS = ("mistral_nemo_12b", "jamba_v0_1_52b", "rwkv6_7b")


CPU = torch.zeros(0)  # a tensor on the device of the spans' work


@pytest.fixture(autouse=True)
def empty_recorder():
    spans.RECORDER.clear()
    yield
    spans.RECORDER.clear()


def _model(name="mistral_nemo_12b"):
    cfg = smoke_config(load_config(name))
    gen = torch.Generator().manual_seed(0)
    return cfg, lm.init_params(gen, cfg, dtype=torch.float32, device="cpu")


def _batch(cfg, B=2, S=16, seed=1):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _train(cfg, params):
    step = make_train_step(cfg, AdamWConfig(warmup_steps=0))
    return step(params, adamw_init(params), _batch(cfg))


def _prefill(cfg, params):
    return lm.prefill(params, cfg, {"tokens": _batch(cfg)["tokens"]}, 24)


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.call"):
            out = fn(*args)
    return out, prof


class _Counting:
    """Counts constructions of the class it stands in for."""

    def __init__(self, real):
        self.real, self.n = real, 0

    def __call__(self, *args, **kwargs):
        self.n += 1
        return self.real(*args, **kwargs)


@pytest.fixture
def counters(monkeypatch):
    ranges = _Counting(torch.profiler.record_function)
    events = _Counting(torch.cuda.Event)
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", ranges)
    monkeypatch.setattr(torch.cuda, "Event", events)
    return ranges, events


@pytest.mark.parametrize("call", [_train, _prefill], ids=["train", "prefill"])
def test_no_profiler_no_range_no_event_no_span(counters, call):
    ranges, events = counters
    cfg, params = _model()
    assert spans.active() is None
    call(cfg, params)
    assert (ranges.n, events.n) == (0, 0)
    assert spans.RECORDER.spans() == []
    # the same counters see the spans' ranges under a profiler
    _profiled(call, cfg, params)
    assert ranges.n == 1 + len(spans.RECORDER.spans()) > 1
    assert events.n == 0  # the CPU: no card, no event


def test_profiled_train_step_records_its_three_spans():
    cfg, params = _model()
    _profiled(_train, cfg, params)
    got = spans.RECORDER.spans()
    assert sorted(s.name for s in got) == sorted(TRAIN_NAMES)
    assert [s.name for s in got] == TRAIN_NAMES  # closed in this order
    assert set(TRAIN_NAMES) <= set(spans.SPAN_NAMES)
    assert all(s.parent is None and s.events is None and s.kind is None for s in got)
    assert all(0 < s.host_s for s in got)
    assert got[0].t1_ns <= got[1].t0_ns and got[1].t1_ns <= got[2].t0_ns


@pytest.mark.parametrize("name", PREFILL_CONFIGS)
def test_profiled_prefill_records_each_layers_halves(name):
    cfg, params = _model(name)
    _profiled(_prefill, cfg, params)
    got = spans.RECORDER.spans()
    top = [s for s in got if s.name == "prefill"]
    assert len(top) == 1 and top[0].parent is None
    mixers = [s for s in got if s.name == "prefill.mixer"]
    ffns = [s for s in got if s.name == "prefill.ffn"]
    assert len(mixers) == len(ffns) == cfg.n_layers
    assert len(got) == 1 + 2 * cfg.n_layers
    assert {s.name for s in got} <= set(spans.SPAN_NAMES)
    assert all(s.parent == top[0].id for s in mixers + ffns)
    plan = cfg.layer_plan()
    assert [s.kind for s in mixers] == [m for m, _ in plan]
    assert [s.kind for s in ffns] == [f for _, f in plan]
    # each layer's mixer ends before its ffn begins, inside the call
    for m, f in zip(mixers, ffns):
        assert top[0].t0_ns <= m.t0_ns <= m.t1_ns <= f.t0_ns <= f.t1_ns <= top[0].t1_ns


@pytest.mark.parametrize("call,names", [(_train, TRAIN_NAMES),
                                        (_prefill, ["prefill", "prefill.mixer",
                                                    "prefill.ffn"])],
                         ids=["train", "prefill"])
def test_span_names_are_user_annotations_inside_the_callers_range(call, names):
    cfg, params = _model()
    _, prof = _profiled(call, cfg, params)
    events = [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    outer = [e for e in events if e.name() == "bench.call"]
    assert len(outer) == 1
    o0 = outer[0].start_ns()
    o1 = o0 + outer[0].duration_ns()
    inner = [e for e in events if e.name() in names]
    want = len(spans.RECORDER.spans())
    assert len(inner) == want and {e.name() for e in inner} == set(names)
    assert all(o0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= o1 for e in inner)


def _same(a, b):
    la, lb = flatten(a)[0], flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("call", [_train, _prefill], ids=["train", "prefill"])
def test_results_are_bit_identical_with_spans_on_and_off(call):
    cfg, params = _model()
    off = call(cfg, params)
    on, _ = _profiled(call, cfg, params)
    assert spans.RECORDER.spans()  # the profiled call did record
    assert _same(off, on)


def test_summary_keeps_the_spans_begun_inside_its_window():
    rec = spans.SpanRecorder()
    for name in ("a", "b", "b"):
        with spans.span(rec, name, CPU):
            pass
    a, b1, b2 = rec.spans()
    everything = rec.summary(a.t0_ns, b2.t1_ns)
    assert {k: v.count for k, v in everything.items()} == {"a": 1, "b": 2}
    assert everything["b"].host_s == pytest.approx(b1.host_s + b2.host_s)
    assert everything["a"].device_s is None
    # a span that began before the window is left out, ending inside it
    assert set(rec.summary(a.t0_ns + 1, b2.t1_ns)) == {"b"}
    assert rec.summary(b1.t0_ns, b1.t0_ns)["b"].count == 1
    assert rec.summary(b2.t1_ns + 1, b2.t1_ns + 10) == {}


def test_parent_stack_is_each_threads_own():
    rec = spans.SpanRecorder()
    seen = {}

    def other():
        with spans.span(rec, "other", CPU) as s:
            seen["other"] = s.parent
            with spans.span(rec, "other.child", CPU) as c:
                seen["other.child"] = c.parent
        seen["left"] = list(rec._stack())

    with spans.span(rec, "outer", CPU) as outer:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with spans.span(rec, "inner", CPU) as inner:
            assert inner.parent == outer.id
    by_name = {s.name: s for s in rec.spans()}
    assert seen["other"] is None and seen["left"] == []
    assert seen["other.child"] == by_name["other"].id
    assert by_name["inner"].parent == by_name["outer"].id
    assert by_name["outer"].parent is None and rec._stack() == []


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on a machine without a card:
    a recorded event holds a time the test sets."""

    clock = [0.0]
    waits = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.ms = None

    def record(self, stream=None):
        self.ms = self.clock[0]

    def synchronize(self):
        self.waits.append(self)

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_summary_sums_the_cards_time_once_it_reached_each_end(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(_FakeEvent, "waits", [])
    rec = spans.SpanRecorder()
    card = SimpleNamespace(device=torch.device("cuda", 0))
    for ms in (2.0, 3.0):
        with spans.span(rec, "prefill.mixer", card, "attn"):
            _FakeEvent.clock[0] += ms
    with spans.span(rec, "prefill.ffn", CPU):
        pass
    assert _FakeEvent.waits == []  # nothing waits while the spans run
    got = rec.summary(0, 2**63 - 1)
    # each card span's end event, and no other
    assert _FakeEvent.waits == [s.events[1] for s in rec.spans()[:2]]
    assert got["prefill.mixer"].count == 2
    assert got["prefill.mixer"].device_s == pytest.approx(5e-3)
    assert got["prefill.ffn"].device_s is None


def test_a_new_profiler_session_drops_the_last_sessions_spans():
    cfg, params = _model()
    _profiled(_train, cfg, params)
    first = spans.RECORDER.spans()
    assert len(first) == len(TRAIN_NAMES)
    # read after its session, the summary still holds them
    got = spans.summary(first[0].t0_ns, first[-1].t1_ns)
    assert {k: v.count for k, v in got.items()} == dict.fromkeys(TRAIN_NAMES, 1)
    _train(cfg, params)  # no session: nothing recorded, nothing dropped
    assert spans.RECORDER.spans() == first
    _profiled(_train, cfg, params)
    second = spans.RECORDER.spans()
    assert len(second) == len(TRAIN_NAMES)
    assert {s.id for s in second}.isdisjoint(s.id for s in first)
