"""The readers of the program's own spans (``lib/program.py``): each
metric's value on a hand-built trace, nothing where the program records
no span, the other readers unmoved by the spans, and one read per step
in a traced run of each cell on the CPU."""

import pytest
from smcbench_helpers import CELLS, run_small

from smcbench.lib import harness, spec
from smcbench.lib.device import PEAKS
from smcbench.lib.trace import parse_chrome_trace

NEW = ["host_syncs_per_step", "sync_idle_share", "weights_device_share",
       "model_device_share", "epn_search_device_share"]
OLD = ["kernels_per_step", "device_idle_share", "step_mfu", "rs_z_roofline",
       "rs_serve_roofline", "loglik_device_share"]
WORK = {"kind": "filter", "N": 1 << 20, "steps": 2, "rs_steps": 2}


def _event(name, ts, dur, cat="kernel", corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def _launch(ts, corr):
    return _event("cudaLaunchKernel", ts, 2, "cuda_runtime", corr=corr)


# the benchmark's ranges, the host's operators, the launches and the
# device's operations of a window of two steps; busy [40, 70), [170, 270),
# [280, 330), [600, 610), [620, 700): 270 us of 1000
BENCH_EVENTS = [
    _event("smcbench.window", 0, 1000, "user_annotation"),
    _event("smcbench.step", 0, 400, "user_annotation"),
    _event("smcbench.step", 500, 400, "user_annotation"),
    _event("smcbench.loglik", 160, 90, "user_annotation"),
    _event("aten::lt", 22, 4, "cpu_op"),
    _event("aten::_local_scalar_dense", 30, 85, "cpu_op"),
    _event("aten::mul", 450, 40, "cpu_op"),
    _launch(25, 1), _launch(35, 2), _launch(165, 3), _launch(270, 4),
    _launch(530, 5), _launch(610, 6),
    _event("void at::native::lt_kernel(float const*)", 40, 20, corr=1),
    _event("Memcpy DtoH (Device -> Pageable)", 60, 10, "gpu_memcpy",
           corr=2),
    _event("void (anonymous namespace)::k_fixed_point<(anonymous "
           "namespace)::ZOut>(float const*)", 170, 100, corr=3),
    _event("void (anonymous namespace)::k_merge_serve(int const*)", 280,
           50, corr=4),
    _event("void at::native::reduce_kernel<512, 1>(float*)", 600, 10,
           corr=5),
    _event("void at::native::elementwise_kernel(float*)", 620, 80, corr=6),
]
# the program's spans over the same stretch
PROGRAM_EVENTS = [
    _event("particles.step", 0, 400, "cpu_op"),
    _event("particles.sync.decide", 20, 100, "cpu_op"),
    _event("particles.model", 150, 100, "cpu_op"),
    _event("particles.weights", 260, 40, "cpu_op"),
    _event("particles.sync.chain", 350, 10, "cpu_op"),
    _event("particles.step", 500, 400, "cpu_op"),
    _event("particles.sync.decide", 520, 40, "cpu_op"),
    _event("particles.sampler.epn_search", 600, 100, "cpu_op"),
    _event("particles.sync.done", 950, 40, "cpu_op"),   # outside a step
]


def _ctx(events):
    return harness.ReadContext(trace=parse_chrome_trace(events), work=WORK,
                               peaks=PEAKS)


def _reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py",
                            "m_" + name)


def _read(name, events):
    return _reader(name).read(_ctx(events))


def test_each_reader_on_a_hand_built_trace():
    ev = BENCH_EVENTS + PROGRAM_EVENTS
    busy = 270.0
    # three reads start inside the two steps; the read at 950 does not
    assert _read("host_syncs_per_step", ev) == pytest.approx(1.5)
    # the gap [70, 170) opens inside the first read; [0, 40), [270, 280),
    # [330, 600), [610, 620) and [700, 1000) open outside every read
    assert _read("sync_idle_share", ev) == pytest.approx(100 * 100 / 1000)
    assert _read("weights_device_share", ev) == pytest.approx(
        100 * 50 / busy)
    assert _read("model_device_share", ev) == pytest.approx(
        100 * 100 / busy)
    assert _read("epn_search_device_share", ev) == pytest.approx(
        100 * 80 / busy)
    assert _read("sync_idle_share", ev) <= _read("device_idle_share", ev)
    assert _read("model_device_share", ev) >= _read("loglik_device_share",
                                                    ev)


def test_a_program_without_spans_gives_nothing():
    for name in NEW:
        assert _read(name, BENCH_EVENTS) is None, name


def test_the_spans_move_no_other_reader():
    ev = BENCH_EVENTS + PROGRAM_EVENTS
    for name in OLD:
        assert _read(name, ev) == _read(name, BENCH_EVENTS), name
    with_spans = parse_chrome_trace(ev).breakdown()
    without = parse_chrome_trace(BENCH_EVENTS).breakdown()
    assert with_spans["device_ops"] == without["device_ops"]
    # the gaps are the same; a gap's label may name the program's span
    assert sum(v for _, v in with_spans["idle_gaps"]) == pytest.approx(
        sum(v for _, v in without["idle_gaps"]))


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_one_host_read_a_step(name):
    """On the CPU the trace holds no kernels: the device shares are
    silent, and each traced step holds its one read (the filter's
    decision; the sampler's stopping rule)."""
    line, _, _ = run_small(name, seconds=0.3, trace=True)
    metrics = line["metrics"]
    assert metrics["host_syncs_per_step"]["value"] == 1.0
    for other in NEW[1:]:
        assert other not in metrics
